"""Atomic, checksummed, rotating checkpoints over models/serialization
(counterpart of deeplearning4j_tpu/resilience/checkpoint.py; the same
files, names and manifest, so a checkpoint directory written by either
package is restored by the other's CheckpointManager).

The writer contract (the periodic consistent checkpoint on the reference's
ModelSerializer zip container):

  * ATOMIC — the payload is written to `<name>.zip.tmp`, fsync'd, then
    os.replace'd over `<name>.zip` (rename is atomic on POSIX), and the
    directory entry is fsync'd. A crash mid-save can leave a stale .tmp
    behind but never a torn `.zip`.
  * VERIFIED — each checkpoint carries a JSON manifest (`<name>.json`,
    written atomically after the payload) recording step/iteration/epoch/
    score/size and the payload's sha256. `restore_latest()` re-hashes the
    payload against the manifest and falls back to the previous checkpoint
    on any mismatch or load error.
  * ROTATED — `keep_last=N` newest checkpoints survive pruning, plus every
    checkpoint whose step is a multiple of `keep_every` (0 = disabled).
  * RESUMABLE — `restore_into(model)` puts params, state, updater slots,
    the iteration and epoch counters and the network's dropout generator
    back into a live network, so `fit(..., checkpoint_manager=...)`
    continues the trajectory (fit 2 + resume + fit 1 == fit 3).

The JAX package records its PRNG key under `rng_key`; the port writes
`rng_key: null` and the state of its own generator (`nn.dropout.Draws`)
under `torch_generator` ({"device": "cuda" or "cpu", "state": base64}),
which `restore_into` restores onto a generator of the same device type.
The two generators do not correspond, so a JAX `rng_key` is ignored with a
warning, and the JAX package ignores `torch_generator`.

`restore` and `restore_latest` build the network on `device` (None: the
card), like every entry point. Payload writes retry on OSError through
`retry_call` (DL4J_TPU_RETRY_* gates). The JAX package's write/restore
metrics, trace spans and its `checkpoint_write` chaos fault point are not
ported yet (ROADMAP A.11).
"""
from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.resilience.retry import retry_call

logger = logging.getLogger("deeplearning4j_tpu_torch")

MANIFEST_VERSION = 1


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without directory fds: rename alone must do
    try:
        os.fsync(fd)
    except OSError:
        pass  # dir fsync unsupported: the rename alone holds
    finally:
        os.close(fd)


def atomic_write_model(model, path: str, save_updater: bool = True,
                       normalizer=None, fsync: bool = True) -> str:
    """Serialize `model` to `path` via temp-file + fsync + rename; returns
    the payload's sha256."""
    from deeplearning4j_tpu_torch.models.serialization import write_model

    tmp = path + ".tmp"
    write_model(model, tmp, save_updater=save_updater, normalizer=normalizer)
    if fsync:
        _fsync_path(tmp)
    sha = _sha256_file(tmp)
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return sha


def atomic_write_json(path: str, payload: Dict[str, Any],
                      fsync: bool = True) -> None:
    """tmp + fsync + rename for JSON sidecars (checkpoint manifests), so
    none is ever read torn."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _generator_state(model) -> Optional[Dict[str, str]]:
    """The network's dropout generator as {"device", "state"} (base64 of
    `torch.Generator.get_state()`), or None where it has none (a stand-in
    for `Draws` without a generator)."""
    gen = getattr(getattr(model, "draws", None), "generator", None)
    if gen is None:
        return None
    state = gen.get_state().numpy().tobytes()
    return {"device": gen.device.type,
            "state": base64.b64encode(state).decode("ascii")}


def _restore_generator(model, manifest: Dict[str, Any]) -> None:
    """Put the manifest's generator state back into the network's, where
    both live on the same device type; a JAX `rng_key` is ignored with a
    warning (the two generators do not correspond)."""
    if manifest.get("rng_key") is not None:
        warnings.warn("checkpoint manifest holds a JAX rng_key: the port's "
                      "dropout generator does not correspond to it and "
                      "keeps its state", stacklevel=3)
    saved = manifest.get("torch_generator")
    gen = getattr(getattr(model, "draws", None), "generator", None)
    if saved is None or gen is None:
        return
    if saved.get("device") != gen.device.type:
        warnings.warn(f"checkpoint's dropout generator was on "
                      f"{saved.get('device')}, the network's is on "
                      f"{gen.device.type}: its state is not restored",
                      stacklevel=3)
        return
    raw = np.frombuffer(base64.b64decode(saved["state"]), np.uint8)
    gen.set_state(torch.from_numpy(raw.copy()))


class CheckpointManager:
    """Rotating atomic checkpoints in one directory.

        cm = CheckpointManager("/ckpt", keep_last=3, keep_every=100)
        cm.save(net)                      # step defaults to net.iteration
        net2, manifest = cm.restore_latest(device="cuda")
        cm.restore_into(net)              # resume in place (params/updater/
                                          # generator/iteration/epoch)

    File layout: `{prefix}_{step:08d}.zip` + `{prefix}_{step:08d}.json`
    (manifest), the JAX package's."""

    def __init__(self, directory: str, keep_last: int = 3,
                 keep_every: int = 0, prefix: str = "checkpoint",
                 save_updater: bool = True, fsync: bool = True):
        self.directory = directory
        self.keep_last = max(1, int(keep_last))
        self.keep_every = max(0, int(keep_every))
        self.prefix = prefix
        self.save_updater = save_updater
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)

    # ---- paths ----
    def _zip(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.zip")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.json")

    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(self.prefix + "_") and name.endswith(".zip"):
                try:
                    out.append(int(name[len(self.prefix) + 1:-4]))
                except ValueError:
                    pass  # a foreign file, not a step
        return sorted(out)

    def manifest(self, step: int) -> Optional[Dict[str, Any]]:
        path = self._manifest_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # torn manifest: treated like a missing one

    def manifests(self) -> List[Dict[str, Any]]:
        """One dict per on-disk checkpoint, ascending by step; checkpoints
        without a readable manifest appear as {"step": s}."""
        return [self.manifest(s) or {"step": s} for s in self.list_steps()]

    # ---- save ----
    def save(self, model, step: Optional[int] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Atomic checkpoint + manifest + rotation; returns the zip path.
        The payload write retries on OSError (a torn disk)
        through the DL4J_TPU_RETRY_* policy."""
        step = int(getattr(model, "iteration", 0)) if step is None else int(step)
        path = self._zip(step)
        sha = retry_call(
            atomic_write_model, model, path,
            save_updater=self.save_updater, fsync=self.fsync,
            retry_on=(OSError,),
            on_retry=lambda i, e: logger.warning(
                "checkpoint write attempt %d failed (%s); retrying",
                i + 1, e))
        score = float(getattr(model, "score_", float("nan")))
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "step": step,
            "iteration": int(getattr(model, "iteration", 0)),
            "epoch": int(getattr(model, "epoch", 0)),
            "time": time.time(),
            "score": score if np.isfinite(score) else None,
            "sha256": sha,
            "size_bytes": os.path.getsize(path),
            "rng_key": None,
            "torch_generator": _generator_state(model),
        }
        if extra:
            manifest.update(extra)
        atomic_write_json(self._manifest_path(step), manifest,
                          fsync=self.fsync)
        self.prune()
        return path

    # ---- verify / rotate ----
    def verify(self, step: int) -> Tuple[bool, str]:
        """-> (ok, detail). Checks the manifest checksum when present and
        the zip container's own CRCs otherwise."""
        path = self._zip(step)
        if not os.path.exists(path):
            return False, "missing payload"
        m = self.manifest(step)
        if m is not None and m.get("sha256"):
            try:
                actual = _sha256_file(path)
            except OSError as e:
                return False, f"unreadable: {e}"
            if actual != m["sha256"]:
                return False, "sha256 mismatch (torn or corrupted write)"
            return True, "ok"
        import zipfile

        try:
            with zipfile.ZipFile(path) as z:
                bad = z.testzip()
            if bad is not None:
                return False, f"zip CRC failure in member {bad!r}"
            return True, "ok (no manifest; zip CRCs only)"
        except Exception as e:
            return False, f"unreadable zip: {e}"

    def prune(self, keep_last: Optional[int] = None,
              keep_every: Optional[int] = None) -> List[int]:
        """Delete checkpoints outside the keep policy; returns removed
        steps. keep_last newest always survive; so does every step that is
        a positive multiple of keep_every."""
        keep_last = self.keep_last if keep_last is None else max(1, keep_last)
        keep_every = self.keep_every if keep_every is None else max(0, keep_every)
        steps = self.list_steps()
        protected = set(steps[-keep_last:])
        if keep_every:
            protected |= {s for s in steps if s and s % keep_every == 0}
        removed = []
        for s in steps:
            if s in protected:
                continue
            for p in (self._zip(s), self._manifest_path(s)):
                if os.path.exists(p):
                    os.remove(p)
            removed.append(s)
        return removed

    # ---- restore ----
    def restore(self, step: int, load_updater: bool = True, device=None):
        """-> (model, manifest) for one specific step, the network built on
        `device` (None: the card); checksum-verified when a manifest
        exists. Raises on failure (restore_latest is the fallback-walking
        variant)."""
        ok, detail = self.verify(step)
        if not ok:
            raise IOError(f"checkpoint step {step}: {detail}")
        from deeplearning4j_tpu_torch.models.serialization import (
            restore_model,
        )

        model = restore_model(self._zip(step), load_updater=load_updater,
                              device=device)
        return model, (self.manifest(step) or {"step": step})

    def restore_latest(self, load_updater: bool = True, device=None):
        """-> (model, manifest) from the newest checkpoint that passes
        checksum verification AND loads onto `device` (None: the card);
        walks backwards past corrupt or torn checkpoints. (None, None) when
        nothing restorable exists. Asking for the card where there is none
        raises, as `device.resolve` does, before any checkpoint is read."""
        from deeplearning4j_tpu_torch import device as device_mod

        device = device_mod.resolve(device)
        for step in reversed(self.list_steps()):
            try:
                return self.restore(step, load_updater=load_updater,
                                    device=device)
            except Exception as e:
                logger.warning("checkpoint step %d unrestorable (%s); "
                               "falling back", step, e)
        return None, None

    def restore_into(self, model, load_updater: bool = True):
        """Resume `model` in place from the newest valid checkpoint, on the
        model's device: params, state, updater slots, iteration/epoch
        counters and the dropout generator's state (a network sharded by
        ParallelWrapper keeps its slices of the whole params). Returns the
        manifest, or None when the directory holds nothing restorable
        (model untouched)."""
        saved, manifest = self.restore_latest(load_updater=load_updater,
                                              device=model.device)
        if saved is None:
            return None
        model.params = saved.params
        model.state = saved.state
        slots = load_updater and saved.opt_state is not None
        if slots:
            model.opt_state = saved.opt_state
        if model._shard_layout is not None:
            # whole params restored into a sharded network (any grid
            # factorization): this rank keeps its slices
            model._shard_layout.place(model, slots=slots)
        model.iteration = int(manifest.get("iteration", saved.iteration))
        model.epoch = int(manifest.get("epoch", saved.epoch))
        _restore_generator(model, manifest)
        return manifest


class CheckpointListener(TrainingListener):
    """Periodic checkpointing behind the listener SPI — the reference
    CheckpointListener contract (every-N-iterations / every-N-epochs /
    every-N-seconds triggers, keepLast/keepEvery rotation), saving through
    the atomic CheckpointManager.

        net.add_listeners(CheckpointListener("/ckpt",
                                             save_every_n_iterations=50))
        net.add_listeners(CheckpointListener(manager,
                                             save_every_n_epochs=1))
    """

    def __init__(self, manager, save_every_n_iterations: int = 0,
                 save_every_n_epochs: int = 0,
                 save_every_n_seconds: float = 0.0,
                 keep_last: int = 3, keep_every: int = 0):
        if not isinstance(manager, CheckpointManager):
            manager = CheckpointManager(str(manager), keep_last=keep_last,
                                        keep_every=keep_every)
        if not (save_every_n_iterations or save_every_n_epochs
                or save_every_n_seconds):
            raise ValueError(
                "CheckpointListener needs at least one trigger: "
                "save_every_n_iterations / save_every_n_epochs / "
                "save_every_n_seconds")
        self.manager = manager
        self.every_iter = max(0, int(save_every_n_iterations))
        self.every_epoch = max(0, int(save_every_n_epochs))
        self.every_seconds = float(save_every_n_seconds)
        self._last_save_time = time.monotonic()
        self._pending: Optional[str] = None
        self.saved_paths: List[str] = []

    def _save(self, model, extra: Optional[Dict[str, Any]] = None) -> None:
        path = self.manager.save(model, extra=extra)
        self._last_save_time = time.monotonic()
        self.saved_paths.append(path)

    def iteration_done(self, model, iteration: int, score: float):
        if not np.isfinite(score):
            return  # never checkpoint a diverged state (sentry's turf)
        trigger = None
        if self.every_iter and iteration and iteration % self.every_iter == 0:
            trigger = "iteration"
        elif (self.every_seconds
              and time.monotonic() - self._last_save_time
              >= self.every_seconds):
            trigger = "time"
        if trigger is None:
            return
        if getattr(model, "_window_replay", False):
            # a step window's replay: the params are the window's end
            # while `iteration` is inside it, and a resume from that pair
            # would apply the window's remaining steps twice. Save at the
            # window's end (training/engine.py fires on_window_end)
            self._pending = trigger
            return
        self._save(model, extra={"trigger": trigger})

    def on_window_end(self, model):
        """A step window's end: (iteration, params) agree again; make the
        save deferred from inside the window. The cadence rounds up to
        the window's end; a resume equals the unbroken run."""
        pending, self._pending = self._pending, None
        if pending is not None and np.isfinite(model.score_):
            self._save(model, extra={"trigger": pending})

    def on_epoch_end(self, model, epoch: int):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0:
            # listeners fire BEFORE fit() increments model.epoch: record
            # epoch+1 so the manifest counts COMPLETED epochs, matching
            # the fit(checkpoint_manager=...) save path — else a resume
            # would repeat the epoch this save just finished
            self._save(model, extra={"trigger": "epoch",
                                     "epoch": epoch + 1})
