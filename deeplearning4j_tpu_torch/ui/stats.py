"""StatsListener — the telemetry producer (counterpart of
deeplearning4j_tpu/ui/stats.py; its reports have the JAX package's keys,
so a storage written by either package is read by the other's server).

Mirrors deeplearning4j-ui-model's BaseStatsListener.java:44-176: per-
iteration score, param/update distribution stats + histograms, memory and
timing, batched to a StatsStorageRouter as plain dict/JSON reports
(storage.py persists them as JSONL).

The params come from the network's param table (`get_param_table`: the
interchange layout, "layer_i/name" keys, nested params flattened with
'/'), so the distributions are the JAX package's for the same weights.
Update stats are param deltas between listener callbacks. The static
report's ``backend`` and ``devices`` describe the network's torch device:
"cuda" and the ``torch.cuda`` devices on the card (with the
``torch.distributed`` rank and world size when a process group is up),
"cpu" otherwise.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except Exception:
        return 0


def _flatten_params(model) -> Dict[str, np.ndarray]:
    """The network's params as {"layer_0/W": array, ...} from its param
    table, in the JAX package's key order (sorted, as a pytree flattens)."""
    table = model.get_param_table()
    return {k: np.asarray(table[k]) for k in sorted(table)}


def _devices(model):
    """(backend, device names) of the network's torch device."""
    import torch

    dev = getattr(model, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return "cpu", ["cpu"]
    names = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
             for i in range(torch.cuda.device_count())]
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        names.append(f"rank {dist.get_rank()} of {dist.get_world_size()}")
    return "cuda", names


def _num(x: float):
    """JSON-safe number: browsers reject NaN/Infinity in JSON.parse."""
    x = float(x)
    return x if np.isfinite(x) else None


def _dist_stats(arr: np.ndarray, bins: int) -> dict:
    flat = arr.reshape(-1).astype(np.float64)
    if flat.size == 0:
        return {}
    out = {
        "mean": _num(flat.mean()),
        "stdev": _num(flat.std()),
        "min": _num(flat.min()),
        "max": _num(flat.max()),
    }
    # histogram over the finite values only — a diverging run (NaN/inf
    # params) must degrade telemetry, never crash training
    finite = flat[np.isfinite(flat)]
    out["nonfinite"] = int(flat.size - finite.size)
    if finite.size:
        counts, edges = np.histogram(finite, bins=bins)
        out["histogram"] = {"counts": counts.tolist(),
                            "min": float(edges[0]), "max": float(edges[-1])}
    return out


class StatsListener(TrainingListener):
    """Collects reports every `frequency` iterations and routes them to a
    StatsStorage(-Router). Attach to any model with listeners support:

        storage = InMemoryStatsStorage()
        net.set_listeners(StatsListener(storage))
        UIServer.get_instance().attach(storage)
    """

    def __init__(self, router, frequency: int = 1,
                 session_id: Optional[str] = None, worker_id: str = "0",
                 collect_histograms: bool = True, histogram_bins: int = 20):
        self.router = router
        self.frequency = max(1, frequency)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._prev_params: Optional[Dict[str, np.ndarray]] = None
        self._last_time: Optional[float] = None
        self._static_sent = False

    # ---- TrainingListener ----
    def iteration_done(self, model, iteration: int, score: float):
        if not self._static_sent:
            self.router.put_static_info(self._static_info(model))
            self._static_sent = True
        if iteration % self.frequency:
            # still need param snapshot cadence for update deltas
            return
        # report timestamp stays wall-clock (the UI renders it); rates come
        # from perf_counter so an NTP step can't corrupt them
        mono = time.perf_counter()
        report: Dict[str, Any] = {
            "session_id": self.session_id,
            "type_id": "StatsListener",
            "worker_id": self.worker_id,
            "timestamp": time.time(),
            "iteration": int(iteration),
            "score": _num(score),
            "memory": {"rss_bytes": _rss_bytes()},
        }
        if self._last_time is not None:
            dt = mono - self._last_time
            report["timing"] = {
                "iterations_per_sec": self.frequency / max(dt, 1e-9),
                "samples_per_sec": (getattr(model, "last_batch_size", 0)
                                    * self.frequency / max(dt, 1e-9)),
                "etl_ms": float(getattr(model, "last_etl_time_ms", 0.0)),
            }
        self._last_time = mono

        flat = _flatten_params(model)
        pstats, ustats = {}, {}
        for name, arr in flat.items():
            bins = self.histogram_bins if self.collect_histograms else 0
            pstats[name] = (_dist_stats(arr, bins) if bins
                            else _dist_stats(arr, 1))
            if self._prev_params is not None and name in self._prev_params:
                delta = arr - self._prev_params[name]
                ustats[name] = (_dist_stats(delta, bins) if bins
                                else _dist_stats(delta, 1))
                # the headline monitoring quantity
                pm = np.abs(arr).mean()
                um = np.abs(delta).mean()
                ustats[name]["ratio_log10"] = (
                    _num(np.log10(um / pm)) if pm > 0 and um > 0 else None)
        report["params"] = pstats
        if ustats:
            report["updates"] = ustats
        self._prev_params = flat
        self.router.put_update(report)

    # ---- static info (one-shot, BaseStatsListener initialization report) ----
    def _static_info(self, model) -> dict:
        backend, devices = _devices(model)
        info = {
            "session_id": self.session_id,
            "type_id": "StatsListener",
            "worker_id": self.worker_id,
            "timestamp": time.time(),
            "static": True,
            "model_class": type(model).__name__,
            "num_params": int(getattr(model, "num_params", lambda: 0)()),
            "num_layers": len(getattr(model, "layers", [])),
            "backend": backend,
            "devices": devices,
        }
        try:
            # architecture graph for the server's /flow and /train/model
            # pages — shipped in the static report so the pages work
            # across processes through the /remote receiver too
            from deeplearning4j_tpu_torch.ui.flow import build_graph

            nodes, edges = build_graph(model)
            info["graph"] = {"nodes": nodes,
                             "edges": [list(e) for e in edges]}
        except Exception:  # visualization must never kill training
            pass  # best-effort UI decoration
        return info
