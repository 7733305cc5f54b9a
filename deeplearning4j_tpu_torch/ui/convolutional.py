"""ConvolutionalIterationListener — activation-grid capture for conv layers
(counterpart of deeplearning4j_tpu/ui/convolutional.py; the activations
come from the port's `feed_forward`, NHWC as in JAX).

Reference: deeplearning4j-ui ConvolutionalIterationListener +
RemoteConvolutionalIterationListener (SURVEY.md §2.10): every N iterations,
tile the channels of each conv layer's activations on a probe input into one
grayscale grid image and publish it (to the UI server or to disk as PNG).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener, logger


def tile_activations(act: np.ndarray, pad: int = 1) -> np.ndarray:
    """[h, w, c] activations -> one [H, W] u8 grid image, channels tiled in
    a near-square grid, each normalized to its own dynamic range."""
    act = np.asarray(act)
    h, w, c = act.shape
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                    np.uint8)
    for i in range(c):
        a = act[..., i]
        lo, hi = float(a.min()), float(a.max())
        u8 = np.zeros_like(a, np.uint8) if hi <= lo else (
            (a - lo) / (hi - lo) * 255).astype(np.uint8)
        r, col = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = u8
    return grid


class ConvolutionalIterationListener(TrainingListener):
    """Capture conv activation grids every `frequency` iterations.

    `probe` is the input batch to visualize (first example used). Images go
    to `output_dir` as PNGs (and/or to a StatsStorageRouter via `router` —
    the RemoteConvolutionalIterationListener path)."""

    def __init__(self, probe, frequency: int = 10,
                 output_dir: Optional[str] = None, router=None,
                 session_id: Optional[str] = None):
        self.probe = np.asarray(probe)
        self.frequency = max(1, frequency)
        self.output_dir = output_dir
        self.router = router
        # align with the StatsListener session to share one dashboard row
        self.session_id = session_id or "default"
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        self.last_grids: List[np.ndarray] = []

    def iteration_done(self, model, iteration: int, score: float):
        if iteration % self.frequency:
            return
        try:
            acts = model.feed_forward(self.probe[:1])
        except Exception as e:  # visualization must never kill training
            logger.warning("conv listener forward failed: %s", e)
            return
        self.last_grids = []
        for li, a in enumerate(acts):
            a = a.detach().float().cpu().numpy()
            if a.ndim != 4:  # NHWC conv activations only
                continue
            grid = tile_activations(a[0])
            self.last_grids.append(grid)
            if self.output_dir:
                self._write_png(
                    os.path.join(self.output_dir,
                                 f"iter{iteration:06d}_layer{li}.png"),
                    grid)
            if self.router is not None:
                self.router.put_update({
                    "session_id": self.session_id,
                    "type_id": "ConvolutionalListener",
                    "iteration": int(iteration),
                    "layer": li,
                    "shape": list(grid.shape),
                    "image": grid.tolist(),
                })

    @staticmethod
    def _write_png(path: str, grid: np.ndarray) -> None:
        from PIL import Image

        Image.fromarray(grid, mode="L").save(path)
