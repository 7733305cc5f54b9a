"""Data-parallel training of the port on torch.distributed (counterpart of
deeplearning4j_tpu/parallel/: its data axis; the other axes, gradient
compression, ParallelInference and ring attention are queued in ROADMAP
A.9)."""
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    MeshSpec,
    build_mesh,
    init_process_group,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
)
