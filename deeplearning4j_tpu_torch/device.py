"""Device resolution for the port's entry points.

Every entry point that creates tensors (`ComputationGraph.init`,
`ZooModel.init`) takes `device=`. Unset means the CUDA card; the CPU runs
only when the caller names it, as the CPU tests do. Asking for CUDA on a
machine without it raises: nothing falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means "cuda". Raises RuntimeError
    when a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested (the default) but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

