"""distributed/ of the port: the publish pointer's reader
(`continuous.read_latest_pointer`, `load_published_model`), which the
serving registry resolves checkpoint directories through, and the elastic
membership registry (`membership.MembershipRegistry`), which the serving
Autoscaler keeps its replicas in. The rest of the JAX package's
distributed/ (the continuous learner and checkpoint watcher, streaming,
the training masters, multi-host training) is ROADMAP A.11."""
from deeplearning4j_tpu_torch.distributed.membership import (  # noqa: F401
    MembershipRegistry,
    WorkerInfo,
    WorkerState,
)
