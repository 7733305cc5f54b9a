"""Parallel training and inference of the port on torch.distributed
(counterpart of deeplearning4j_tpu/parallel/): ParallelWrapper over the
dcn, data, model, fsdp, seq and pipe axes of a grid of ranks (`mesh`),
ParallelInference (`inference`: dynamic batching on one device, or rank 0
dispatching over a grid's data axis), ring attention over the seq axis
(`ring`), ShardedTransformerLM over data x model x seq x pipe x expert
(`transformer`), the fsdp param layout and the remat policies (`layout`),
and threshold gradient compression (`compression`). The wrapper trains a
ComputationGraph with one input and one output only, as the JAX
package's does."""
from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    EncodingHandler,
)
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    ParallelInference,
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
