"""The publish pointer protocol's read side (counterpart of the first
two readers of deeplearning4j_tpu/distributed/continuous.py).

A continuous learner publishes each round as a CheckpointManager
checkpoint (zip + sha256 manifest) followed by a `latest.json` pointer
naming its step; the pointer is the commit point, so a crash between the
two leaves the previous publication intact and the new zip invisible.
`read_latest_pointer` reads the pointer (an absent or torn one reads as
"nothing published yet") and `load_published_model` restores the
pointed-at checkpoint with its sha256 verified first: a torn publish
raises IOError instead of producing a model.

The pointer's JSON is the JAX package's (`pointer_version`, `step`,
`sha256`, `time`, `trace_id`), so either package reads the other's
publications. The writer side (`ContinuousLearner`,
`write_latest_pointer`), `CheckpointWatcher` and their metrics and trace
links are ROADMAP A.11.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager

LATEST_POINTER = "latest.json"
POINTER_VERSION = 1


def read_latest_pointer(directory: str) -> Optional[Dict[str, Any]]:
    """The current publication, or None (never raises: an absent or torn
    pointer reads as "nothing published yet")."""
    try:
        with open(os.path.join(directory, LATEST_POINTER)) as f:
            ptr = json.load(f)
        int(ptr["step"])
        return ptr
    except (OSError, ValueError, KeyError, TypeError):
        return None


def load_published_model(directory: str, step: Optional[int] = None,
                         device=None):
    """-> (model, manifest) for the pointed-at (or given, else newest)
    publication on `device` (None: the card), sha256-verified through
    `CheckpointManager.restore` before the network is built: a torn
    publish raises IOError."""
    mgr = CheckpointManager(directory)
    if step is None:
        ptr = read_latest_pointer(directory)
        if ptr is not None:
            step = int(ptr["step"])
        else:
            steps = mgr.list_steps()
            if not steps:
                raise ValueError(
                    f"no published checkpoints under {directory!r}")
            step = steps[-1]
    return mgr.restore(int(step), load_updater=False, device=device)
