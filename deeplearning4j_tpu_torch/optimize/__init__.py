"""Training listeners of the port (the listener half of
deeplearning4j_tpu/optimize; the line-search solvers are not ported yet,
ROADMAP A.7)."""
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
