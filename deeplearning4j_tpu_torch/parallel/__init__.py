"""Parallel training of the port on torch.distributed (counterpart of
deeplearning4j_tpu/parallel/): ParallelWrapper over the data, model, fsdp,
seq and pipe axes of a grid of ranks (`mesh`), ring attention over the seq
axis (`ring`), ShardedTransformerLM over data x model x seq x pipe x
expert (`transformer`), the fsdp param layout and the remat policies
(`layout`), and threshold gradient compression (`compression`).
ParallelInference, the dcn axis and ComputationGraphs with several inputs
or outputs in the wrapper are queued in ROADMAP A.9's rest."""
from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    EncodingHandler,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid,
    MeshSpec,
    build_mesh,
    init_process_group,
)
from deeplearning4j_tpu_torch.parallel.ring import (  # noqa: F401
    active_sequence_axis,
    ring_attention,
    ring_attention_sharded,
    sequence_parallel,
)
from deeplearning4j_tpu_torch.parallel.transformer import (  # noqa: F401
    ShardedTransformerLM,
    TransformerConfig,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
)
