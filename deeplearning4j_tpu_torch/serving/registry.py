"""ModelRegistry — many named, versioned models behind one fleet
(counterpart of deeplearning4j_tpu/serving/registry.py).

Every `(name, version)` gets its OWN `InferenceServer` — its own buckets,
breaker, deadline policy, queue — so one model's overload or open breaker
never sheds a neighbour's traffic.

Sources served side by side with no user-code changes (`resolve_model`):

  * a live model object (anything with ``output(x)``) or a raw
    ``dispatch(batch)`` callable,
  * a zoo model by name (``zoo:LeNet``, built and initialised here),
  * a Keras file (``*.h5`` / ``*.hdf5`` / ``*.keras``) through the port's
    importer, which reads HDF5 itself (no h5py needed),
  * a native checkpoint zip (``models/serialization.py``, either
    package's),
  * a CheckpointManager checkpoint DIRECTORY (a continuous learner's
    publish target): the ``latest.json`` pointer (or the newest step) is
    resolved through its manifest and the zip's sha256 is verified BEFORE
    a network is built, so a torn publish raises IOError and is never
    served (`distributed/continuous.py`).

Every network is built on `device` (None: the card), as at every entry
point of the port.

Warm starts: with a warm-cache directory (``DL4J_TPU_WARM_CACHE`` or the
``warm_cache_dir`` argument) ``warm()`` both dispatches every bucket AND
records the warm manifest (serving/warmstart.py), so the NEXT replica's
``warm()`` needs no example: it synthesizes the batch from the manifest.

Canary plumbing: each version's dispatch is wrapped with the
``canary_dispatch`` / ``canary_nan`` chaos fault points
(resilience/chaos.py), which are ARMED ONLY while that version is the
active canary (``ModelVersion.canary``, set by serving/router.py's Router
for the length of a rollout) — a deliberately-broken canary is injectable
with ``DL4J_TPU_CHAOS=canary_dispatch@1:2:3`` while the stable version and
all warmups stay untouched. Each ModelVersion also keeps its unwrapped
``dispatch`` and its ``server_kwargs``: what serving/autoscaler.py's
``Autoscaler.for_model`` builds replicas from (the same network, so the
replicas share its weights).

A registry's servers dispatch in one process, each model on its own
device; a multi-rank grid serves through `parallel.ParallelInference`, so
the JAX constructor's `mesh` is left out.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving import warmstart
from deeplearning4j_tpu_torch.serving.runtime import InferenceServer

ZOO_PREFIX = "zoo:"

# live registries (weak: a dropped registry must not pin itself)
_REGISTRIES: "weakref.WeakSet[ModelRegistry]" = weakref.WeakSet()


def live_registries() -> List["ModelRegistry"]:
    return list(_REGISTRIES)


def resolve_model(source, device=None):
    """Turn a registration source into a live network on `device` (None:
    the card) — the same string a user would hand the import and restore
    entry points works here verbatim:

      ``zoo:<Name>``                 a zoo architecture, built + initialised
      ``*.h5`` ``*.hdf5`` ``*.keras`` a Keras file through modelimport
      ``*.zip``                      a native serialized model
      a directory                    a CheckpointManager publish directory,
                                     resolved through its latest pointer
                                     with the sha256 verified first (a
                                     torn publish raises IOError)
      anything else                  returned as is (already a model)
    """
    if not isinstance(source, str):
        return source
    if os.path.isdir(source):
        from deeplearning4j_tpu_torch.distributed.continuous import (
            load_published_model,
        )

        model, _manifest = load_published_model(source, device=device)
        return model
    if source.startswith(ZOO_PREFIX):
        from deeplearning4j_tpu_torch import zoo

        name = source[len(ZOO_PREFIX):]
        builder = getattr(zoo, name, None)
        if builder is None:
            raise ValueError(f"unknown zoo model {name!r}")
        return builder().init(device=device)
    if source.endswith((".h5", ".hdf5", ".keras")):
        from deeplearning4j_tpu_torch.modelimport.keras import (
            import_keras_model_and_weights,
        )

        return import_keras_model_and_weights(source, device=device)
    if source.endswith(".zip"):
        from deeplearning4j_tpu_torch.models.serialization import (
            restore_model,
        )

        return restore_model(source, load_updater=False, device=device)
    raise ValueError(
        f"model source {source!r} is not zoo:<Name>, *.h5/*.keras, "
        f"*.zip, or a checkpoint directory")


class ModelVersion:
    """One served version: a name + version tag bound to its own
    InferenceServer. ``canary`` is flipped by the router for the
    duration of a rollout — it arms the canary chaos points and routes
    this version's outcomes into the per-version SLO selectors."""

    def __init__(self, name: str, version: str, server: InferenceServer):
        self.name = name
        self.version = version
        self.server = server
        self.canary = False
        # the UNWRAPPED dispatch + serving policy this version was
        # registered with: what Autoscaler.for_model clones replica
        # servers from (replicas serve stable traffic, so they never
        # carry the canary fault wrapper)
        self.dispatch: Optional[Callable] = None
        self.server_kwargs: Dict[str, object] = {}

    @property
    def key(self) -> str:
        return f"{self.name}:{self.version}"

    def snapshot(self) -> dict:
        snap = self.server.snapshot()
        snap.update(model=self.name, version=self.version,
                    canary=self.canary)
        return snap


class ModelEntry:
    """All versions of one named model + which one is stable."""

    def __init__(self, name: str):
        self.name = name
        self.versions: Dict[str, ModelVersion] = {}
        self.stable: Optional[str] = None

    def stable_version(self) -> ModelVersion:
        if self.stable is None:
            raise KeyError(f"model {self.name!r} has no stable version")
        return self.versions[self.stable]


class ModelRegistry:
    """The fleet's model table. Thread-safe; servers are constructed at
    register() time (their dispatcher threads idle until traffic) and
    drained at unregister()/shutdown(). `device` (None: the card) is
    where sources are built."""

    def __init__(self, warm_cache_dir: Optional[str] = None, device=None):
        self.device = device
        self._lock = threading.Lock()
        # the version chain (ModelEntry.versions / .stable) is mutated
        # ONLY inside this registry's locked methods — callers holding a
        # ModelEntry from entry() must treat it as read-only
        self._entries: Dict[str, ModelEntry] = {}  # guarded-by: self._lock
        d = warm_cache_dir or warmstart.cache_dir_from_env()
        self.warm_cache_dir = warmstart.enable(d) if d else None
        _REGISTRIES.add(self)

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def register(self, name: str, source=None,
                 dispatch: Optional[Callable] = None,
                 version: str = "v1",
                 stable: Optional[bool] = None,
                 device=None,
                 **server_kwargs) -> ModelVersion:
        """Add one `(name, version)`. `source` is anything `resolve_model`
        accepts, built on `device` (default: the registry's); `dispatch`
        bypasses model loading (tests, custom stacks). Per-model serving
        policy — buckets, breaker, deadline, shed policy, queue/batch
        limits, tenancy — rides in through `server_kwargs` untouched. The
        first version of a name becomes stable unless `stable=False`."""
        if source is None and dispatch is None:
            raise ValueError("register() needs a model source or a "
                             "dispatch callable")
        device = self.device if device is None else device
        model = (resolve_model(source, device=device)
                 if source is not None else None)
        server_kwargs.setdefault("name", f"{name}:{version}")
        mv_holder: List[ModelVersion] = []
        inner = (InferenceServer._build_model_dispatch(model)[0]
                 if dispatch is None else dispatch)
        server = InferenceServer(
            dispatch=self._canary_faulted(inner, mv_holder),
            **server_kwargs)
        server.model = model
        mv = ModelVersion(name, version, server)
        mv.dispatch = inner
        mv.server_kwargs = {k: v for k, v in server_kwargs.items()
                            if k not in ("name", "warmup_example")}
        mv_holder.append(mv)
        with self._lock:
            entry = self._entries.setdefault(name, ModelEntry(name))
            taken = version in entry.versions
            if not taken:
                entry.versions[version] = mv
                if stable or (stable is None and entry.stable is None):
                    entry.stable = version
        if taken:
            server.shutdown()
            raise ValueError(f"{mv.key} already registered")
        return mv

    @staticmethod
    def _canary_faulted(inner: Callable, mv_holder: List[ModelVersion]):
        """Wrap a dispatch with the canary chaos points, armed only
        while this version IS the canary — warmups and stable traffic
        never consume the injection schedule, so
        ``DL4J_TPU_CHAOS=canary_dispatch@1:2:3`` breaks exactly the
        first three canary batches."""

        def dispatch(xp):
            mv = mv_holder[0] if mv_holder else None
            is_canary = mv is not None and mv.canary
            if is_canary:
                chaos.fault_point("canary_dispatch")
            out = inner(xp)
            if is_canary and chaos.silent_fault("canary_nan"):
                out = torch.full_like(torch.as_tensor(out).float(),
                                      float("nan"))
            return out

        return dispatch

    # ------------------------------------------------------------------
    # warm starts
    # ------------------------------------------------------------------
    def warm(self, name: str, version: Optional[str] = None,
             example=None) -> ModelVersion:
        """Warm one version's buckets. With an `example` (first boot):
        dispatch every bucket and, when a warm-cache directory is set,
        record the manifest. Without one (replica restart): synthesize
        the example from the recorded manifest."""
        mv = self.get(name, version)
        if example is None:
            if self.warm_cache_dir is None:
                raise ValueError(
                    f"warm({mv.key}) without an example needs a warm "
                    f"cache dir (DL4J_TPU_WARM_CACHE) with a recorded "
                    f"manifest")
            manifest = warmstart.load_manifest(
                self.warm_cache_dir, name, mv.version)
            if manifest is None:
                raise FileNotFoundError(
                    f"no warm manifest for {mv.key} under "
                    f"{self.warm_cache_dir} — first boot must pass an "
                    f"example")
            example = warmstart.warmup_example(manifest)
        mv.server.warmup(example)
        if self.warm_cache_dir is not None:
            warmstart.record_warm(self.warm_cache_dir, name, mv.version,
                                  example, mv.server.buckets.sizes)
        return mv

    def replica_example(self, mv: "ModelVersion"):
        """The warm-manifest example a NEW replica of `mv` warms up with;
        None when no warm cache / manifest is recorded."""
        if self.warm_cache_dir is None:
            return None
        manifest = warmstart.load_manifest(self.warm_cache_dir, mv.name,
                                           mv.version)
        if manifest is None:
            return None
        return warmstart.warmup_example(manifest)

    # ------------------------------------------------------------------
    # lookup / lifecycle
    # ------------------------------------------------------------------
    def get(self, name: str, version: Optional[str] = None) -> ModelVersion:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} not registered")
            if version is None:
                return entry.stable_version()
            mv = entry.versions.get(version)
            if mv is None:
                raise KeyError(f"model {name}:{version} not registered")
            return mv

    def entry(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} not registered")
            return entry

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def set_stable(self, name: str, version: str) -> None:
        with self._lock:
            entry = self._entries[name]
            if version not in entry.versions:
                raise KeyError(f"model {name}:{version} not registered")
            entry.stable = version

    def unregister(self, name: str, version: Optional[str] = None,
                   timeout: float = 5.0) -> None:
        """Drain and drop one version (or the whole model)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                return
            if version is None:
                victims = list(entry.versions.values())
                del self._entries[name]
            else:
                mv = entry.versions.pop(version, None)
                victims = [mv] if mv is not None else []
                if entry.stable == version:
                    entry.stable = next(iter(entry.versions), None)
                if not entry.versions:
                    del self._entries[name]
        for mv in victims:
            mv.server.shutdown(timeout=timeout)

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._lock:
            victims = [mv for e in self._entries.values()
                       for mv in e.versions.values()]
            self._entries.clear()
        for mv in victims:
            mv.server.shutdown(timeout=timeout)

    def snapshot(self) -> dict:
        """Machine-readable fleet state."""
        with self._lock:
            entries = {name: (e.stable, list(e.versions.values()))
                       for name, e in self._entries.items()}
        return {
            "warm_cache_dir": self.warm_cache_dir,
            "models": {
                name: {
                    "stable": stable,
                    "versions": [mv.snapshot() for mv in mvs],
                }
                for name, (stable, mvs) in sorted(entries.items())
            },
        }
