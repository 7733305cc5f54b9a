"""Network runtimes of the port, and the checkpoint zip (serialization)."""
from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph  # noqa: F401
from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork  # noqa: F401
from deeplearning4j_tpu_torch.models.serialization import (  # noqa: F401
    restore_computation_graph,
    restore_model,
    restore_multi_layer_network,
    restore_normalizer,
    write_model,
)
