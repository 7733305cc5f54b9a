"""Typed reader for `DL4J_TPU_*` environment gates (a copy of the parser in
deeplearning4j_tpu/util/envflags.py; the tuner's override overlay and knob
registry are not part of the port yet).

Unset, empty or unparsable values read as the caller's default: a typo'd
gate must never crash the code path reading it.

The port reads the same gate names as the JAX package, so one deployment's
settings mean the same on both. Booleans share the JAX package's spelling
set: 1, true, yes and on (any case, whitespace stripped) enable a gate;
anything else that is set disables it.
"""
from __future__ import annotations

import os
from typing import Optional


def value(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string value, whitespace-stripped; `default` when unset."""
    env = os.environ.get(name)
    return default if env is None else env.strip()


TRUTHY = frozenset({"1", "true", "yes", "on"})


def flag(name: str) -> Optional[bool]:
    """True for a truthy spelling, False for anything else that is set,
    None when the variable is unset."""
    env = value(name)
    return None if env is None else env.lower() in TRUTHY


def enabled(name: str, default: bool = False) -> bool:
    """Boolean gate: `default` when unset, else `flag`."""
    f = flag(name)
    return default if f is None else f


def int_value(name: str, default: int) -> int:
    """Integer gate: unset, empty or unparsable values read as `default`."""
    raw = value(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def float_value(name: str, default: float) -> float:
    """Float gate; same garbage tolerance as int_value."""
    raw = value(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default
