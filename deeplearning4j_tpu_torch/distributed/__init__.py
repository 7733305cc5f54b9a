"""distributed/ of the port: only the publish pointer's reader
(`continuous.read_latest_pointer`, `load_published_model`), which the
serving registry resolves checkpoint directories through. The rest of the
JAX package's distributed/ (the continuous learner and checkpoint
watcher, streaming, membership, multi-host training) is ROADMAP A.11."""
