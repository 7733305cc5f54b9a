"""Parallel training of the port on torch.distributed (counterpart of
deeplearning4j_tpu/parallel/): ParallelWrapper over the data, model and
fsdp axes of a grid of ranks (`mesh`), the fsdp param layout and the remat
policies (`layout`), and threshold gradient compression (`compression`).
The seq (ring attention) and pipe axes, ShardedTransformerLM,
ParallelInference and the dcn and expert axes are queued in ROADMAP A.9's
rest."""
from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    EncodingHandler,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid,
    MeshSpec,
    build_mesh,
    init_process_group,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
)
