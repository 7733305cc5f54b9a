"""Network runtimes of the port."""
from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph  # noqa: F401
