"""Solvers and training listeners of the port (counterpart of
deeplearning4j_tpu/optimize): the line-search solver family
(`solvers`) and the listener SPI with its standard listeners
(`listeners`)."""
from deeplearning4j_tpu_torch.optimize.solvers import (  # noqa: F401
    ConjugateGradient,
    ConvexOptimizer,
    DefaultStepFunction,
    EpsTermination,
    GradientStepFunction,
    LBFGS,
    LineGradientDescent,
    NegativeDefaultStepFunction,
    NegativeGradientStepFunction,
    Norm2Termination,
    Solver,
    StochasticGradientDescent,
    TerminationCondition,
    ZeroDirection,
    backtrack_line_search,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener,
    CollectScoresListener,
    EvaluativeListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ProfilerListener,
    ScoreIterationListener,
    SleepyTrainingListener,
    TimeIterationListener,
    TrainingListener,
    fire_lifecycle,
)
