"""Warm manifests — a restarted replica warms up with no example
(counterpart of deeplearning4j_tpu/serving/warmstart.py).

`InferenceServer.warmup` dispatches every bucketed shape once, so steady
state never meets a cold shape; but a fresh replica (restart, scale-up)
needs an example request to warm with. `record_warm` writes one small
JSON per `(model, version)` recording the request signature (the row
shape without the batch axis, and the dtype) and the bucket sizes that
were warmed; a fresh replica that has never seen a request calls
`load_manifest` / `warmup_example` to synthesize the warmup batch from
the manifest alone, so boot order no longer depends on traffic. A
manifest is written through `resilience/checkpoint.py`'s
`atomic_write_json` (a torn manifest must not brick a replica boot) and
is byte-compatible with the JAX package's: each package reads the
other's.

Gate: `DL4J_TPU_WARM_CACHE`, a directory path; when set, the
ModelRegistry keeps its manifests there.

What it cannot do. The JAX module's `enable(cache_dir)` also points JAX's
persistent compilation cache at the directory, so a replica's warmup
compiles are disk reads. Eager PyTorch has no compiled executables to
persist: a warmup here pays cuDNN's algorithm choice, the kernels' first
launches and the allocator's blocks, none of which outlives the process.
`enable` only creates the directory; the port's CUDA kernels are built
once per checkout into `ops/_build.py`'s own cache, which this module
does not touch.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.util import envflags

WARM_CACHE_GATE = "DL4J_TPU_WARM_CACHE"
MANIFEST_PREFIX = "warm_"

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def cache_dir_from_env() -> Optional[str]:
    """The DL4J_TPU_WARM_CACHE directory, or None when unset."""
    d = envflags.value(WARM_CACHE_GATE)
    return d or None


def enable(cache_dir: str) -> str:
    """Creates `cache_dir` (absolute) for the manifests and returns it.
    Idempotent. There is no compilation cache to point there (see the
    module docstring)."""
    d = os.path.abspath(cache_dir)
    os.makedirs(d, exist_ok=True)
    return d


def _slug(name: str) -> str:
    return _SLUG_RE.sub("_", name)


def manifest_path(cache_dir: str, model: str, version: str) -> str:
    return os.path.join(
        cache_dir, f"{MANIFEST_PREFIX}{_slug(model)}__{_slug(version)}.json")


def record_warm(cache_dir: str, model: str, version: str,
                example, bucket_sizes: Sequence[int]) -> str:
    """Persist the warm recipe for one model version: the per-row request
    signature (shape minus the batch axis, and dtype) and the bucket
    sizes that were warmed. Atomic write: a replica booting mid-write
    reads the old manifest or none, never a torn one."""
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        atomic_write_json,
    )

    row = np.asarray(example)[:1]
    manifest: Dict[str, Any] = {
        "model": model,
        "version": version,
        "row_shape": [int(s) for s in row.shape[1:]],
        "dtype": str(row.dtype),
        "buckets": sorted(int(b) for b in bucket_sizes),
    }
    os.makedirs(cache_dir, exist_ok=True)
    path = manifest_path(cache_dir, model, version)
    atomic_write_json(path, manifest)
    return path


def load_manifest(cache_dir: str, model: str,
                  version: str) -> Optional[Dict[str, Any]]:
    """The recorded warm recipe, or None when this (model, version) was
    never warmed against this directory (first boot ever)."""
    path = manifest_path(cache_dir, model, version)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def warmup_example(manifest: Dict[str, Any]) -> np.ndarray:
    """A one-row warmup batch from a manifest. Zeros are shape- and
    dtype-faithful, which is all a warmup needs: the values never reach a
    user."""
    shape = [1] + [int(s) for s in manifest.get("row_shape", [])]
    return np.zeros(shape, dtype=np.dtype(manifest.get("dtype", "float32")))


def list_manifests(cache_dir: str) -> List[Dict[str, Any]]:
    """Every warm manifest under `cache_dir` ("what can boot warm
    here")."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(cache_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(MANIFEST_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(cache_dir, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out
