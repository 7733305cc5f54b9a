"""The port's fault injection (deeplearning4j_tpu_torch/resilience/chaos.py)
and elastic membership (deeplearning4j_tpu_torch/distributed/
membership.py) against the JAX package's on the same inputs.

Exact parity throughout: the same `DL4J_TPU_CHAOS` spec fires on the same
calls of the same points (raising and silent) and the same iterator
batches; the same register / heartbeat / begin_split / suspect_silent /
observe_split_durations / evict / barrier calls on a fake clock give the
same snapshots, the same transition counters and gauges, the same pending
events and the same evicted ids in both packages, through heartbeat
eviction, skew eviction, a chaos-failed rejoin with decorrelated backoff
and the rejoin that follows. Both packages' global registries, tracers and
chaos counters are reset around every test.
"""
import importlib
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.distributed import membership as jmembership
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.telemetry import context as jcontext
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.distributed import membership
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.telemetry import context
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import trace
from test_torch_telemetry import live_text

# the packages export a `retry` function that shadows the module's name
jretry = importlib.import_module("deeplearning4j_tpu.resilience.retry")
retry = importlib.import_module("deeplearning4j_tpu_torch.resilience.retry")
# (chaos, membership, retry, metrics, trace, context) of each package
PACKAGES = {"jax": (jchaos, jmembership, jretry, jmetrics, jtrace, jcontext),
            "port": (chaos, membership, retry, metrics, trace, context)}
FAMILIES = ("dl4j_tpu_chaos_injections_total",
            "dl4j_tpu_membership_transitions_total",
            "dl4j_tpu_membership_active_workers",
            "dl4j_tpu_membership_generation")


def _reset():
    for c, _, r, m, t, _ in PACKAGES.values():
        c.reset_fault_points()
        m.registry().reset()
        t.configure(enabled=None)
        t.tracer().clear()
        r.seed_jitter(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for k in ("DL4J_TPU_CHAOS", "DL4J_TPU_TELEMETRY",
              "DL4J_TPU_HEARTBEAT_TIMEOUT", "DL4J_TPU_EVICT_SKEW_RATIO",
              "DL4J_TPU_EVICT_SKEW_SPLITS", "DL4J_TPU_REJOIN_BACKOFF"):
        monkeypatch.delenv(k, raising=False)
    _reset()
    yield
    _reset()


def _rendered(m):
    return live_text(m, FAMILIES)


# ===========================================================================
# chaos
# ===========================================================================


@pytest.mark.parametrize("spec", [
    "serving_dispatch@1:3,serving_nan@2,canary_dispatch@x:4",
    " rejoin@2 , , bogus, tenant_burst@1:1:5,frame_drop@3",
    "",
])
def test_a_chaos_spec_fires_on_the_same_calls(monkeypatch, spec):
    monkeypatch.setenv("DL4J_TPU_CHAOS", spec)
    points = ["serving_dispatch", "serving_nan", "canary_dispatch",
              "rejoin", "tenant_burst", "frame_drop", "unlisted"]
    got = {}
    for name, (c, *_rest, m, _t, _x) in PACKAGES.items():
        c.reset_fault_points()
        fired = []
        for call in range(6):
            for p in points:
                if (call + len(p)) % 2:
                    fired.append((p, c.silent_fault(p)))
                else:
                    try:
                        c.fault_point(p)
                        fired.append((p, False))
                    except c.ChaosError as e:
                        assert isinstance(e, IOError)
                        fired.append((p, str(e)))
        got[name] = (fired, live_text(m, (
            "dl4j_tpu_chaos_injections_total",)))
    assert got["port"] == got["jax"]
    # a changed gate re-parses; reset re-arms
    monkeypatch.setenv("DL4J_TPU_CHAOS", "p@1")
    assert chaos.silent_fault("p") and jchaos.silent_fault("p")
    assert not chaos.silent_fault("p")
    chaos.reset_fault_points()
    assert chaos.silent_fault("p")


def test_chaos_iterator_fails_and_poisons_the_same_batches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    y = rng.standard_normal((20, 2)).astype(np.float32)
    runs = {}
    for name, ds_cls, it_cls, c in (
            ("jax", JDataSet, JListIterator, jchaos),
            ("port", DataSet, ListDataSetIterator, chaos)):
        it = c.ChaosDataSetIterator(it_cls(ds_cls(x, y), batch=4),
                                    nan_at=(2, 7), fail_at=(4, 9))
        seen = []
        for _ in range(2):  # two epochs: counts are monotonic
            it.reset()
            while True:
                try:
                    ds = next(it)
                except StopIteration:
                    break
                except c.ChaosError:
                    seen.append("fail")
                    continue
                f = np.asarray(ds.features)
                seen.append("nan" if np.isnan(f).all() else float(f.sum()))
        runs[name] = (seen, it.count, it.batch_size(), it.async_supported())
    assert runs["port"][0][:3] == runs["jax"][0][:3]
    assert [v if isinstance(v, str) else round(v, 4)
            for v in runs["port"][0]] == [
        v if isinstance(v, str) else round(v, 4) for v in runs["jax"][0]]
    assert runs["port"][1:] == runs["jax"][1:]
    # a tensor batch is poisoned as a tensor
    t = chaos.ChaosDataSetIterator(ListDataSetIterator(DataSet(
        torch.ones(4, 2), torch.ones(4, 1)), batch=4), nan_at=(1,))
    ds = next(iter(t))
    assert isinstance(ds.features, torch.Tensor)
    assert torch.isnan(ds.features).all()


# ===========================================================================
# membership
# ===========================================================================


def _membership_arc(mem_mod, chaos_mod, retry_mod, ctx_mod, monkeypatch):
    """One scripted life of a registry on a fake clock: joins, beats,
    silence -> suspect -> evict, a rescue, skew draining, exception
    eviction, a chaos-failed rejoin with decorrelated backoff, the
    rejoin, remote events. Returns the snapshot after every step and
    the values each call returned."""
    monkeypatch.setenv("DL4J_TPU_HEARTBEAT_TIMEOUT", "10")
    monkeypatch.setenv("DL4J_TPU_EVICT_SKEW_RATIO", "1.5")
    monkeypatch.setenv("DL4J_TPU_EVICT_SKEW_SPLITS", "2")
    monkeypatch.setenv("DL4J_TPU_REJOIN_BACKOFF", "0.5")
    monkeypatch.setenv("DL4J_TPU_CHAOS", "rejoin@1")
    chaos_mod.reset_fault_points()
    retry_mod.seed_jitter(11)
    now = [0.0]
    reg = mem_mod.MembershipRegistry(clock=lambda: now[0])
    reg.set_trace_context(ctx_mod.new_trace())
    steps = []

    def step(what, value=None):
        steps.append((what, value, reg.snapshot()))

    for w in (0, 1, 2, "w3"):
        reg.register(w)
    step("register", reg.register(1).worker_id)
    slow = {0: 1.0, 1: 1.1, 2: 0.9, "w3": 3.0}
    step("skew 1", reg.observe_split_durations(slow))
    step("skew 2", reg.observe_split_durations(slow))
    reg.begin_split(0)
    now[0] = 5.0
    for w in (0, 1, 2):
        reg.heartbeat(w)
    now[0] = 16.0
    step("suspect", reg.suspect_silent(only=[0, 1, 2]))
    reg.heartbeat(1)  # rescued
    now[0] = 17.0
    step("evict silent", reg.suspect_silent())
    reg.report_failure(1, OSError("host gone"))
    step("host loss", reg.evicted_ids())
    step("not active", reg.evict(1, "exception"))
    now[0] = 17.2
    step("barrier early", reg.barrier(3))
    now[0] = 30.0
    step("barrier chaos", reg.barrier(4))
    now[0] = 60.0
    step("barrier", reg.barrier(5))
    reg.mark_silent(0)
    step("mark silent", reg.suspect_silent())
    reg.apply_remote_event({"event": "join", "worker": "r9"}, origin=2)
    reg.apply_remote_event({"event": "evict_heartbeat", "worker": "r9",
                            "reason": "heartbeat"}, origin=2)
    step("remote", sorted(str(w) for w in reg.active_ids()))
    events = [dict(e, process_index=None)
              for e in reg.drain_pending_events()]
    info = reg.get(0)
    return steps, events, (reg.generation, reg.splits_seen,
                           reg.timeout_s(), info.state.value,
                           info.resume_split, info.rejoin_attempts)


def test_membership_gives_the_same_snapshots_through_its_arcs(monkeypatch):
    got = {}
    for name, (c, mem, r, m, t, ctx) in PACKAGES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arc = _membership_arc(mem, c, r, ctx, monkeypatch)
        got[name] = (arc, _rendered(m))
    assert got["port"] == got["jax"]
    (steps, events, final), text = got["port"]
    what = {w: v for w, v, _ in steps}
    assert what["skew 1"]["w3"] > 1.5 and what["evict silent"] == [0, 2]
    # the chaos-failed admission backs worker 0 off; the others rejoin
    assert what["barrier early"] == [] and what["barrier chaos"] == [1, 2]
    assert what["barrier"] == [0]
    assert final[3] == "suspect" and final[5] == 1  # marked silent once
    assert 'event="rejoin_failed"' in text and 'event="rejoin"' in text


def test_eviction_writes_a_bundle_and_planned_drains_stay_silent(
        monkeypatch, tmp_path):
    """A failure eviction warns and writes one eviction bundle (gate on);
    the planned scale_in drain does neither, in both packages; the
    membership instant joins the owner's trace."""
    got = {}
    for name, (c, mem, r, m, t, ctx) in PACKAGES.items():
        d = tmp_path / name
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(d))
        t.configure(enabled=True)
        reg = mem.MembershipRegistry(auto_rejoin=False)
        root = ctx.new_trace()
        reg.set_trace_context(root)
        reg.register("a")
        reg.register("b")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reg.evict("a", "scale_in", flight=False)
            planned = len(caught)
            reg.evict("b", "crash", exc=RuntimeError("died"))
        bundles = sorted(p.name.rsplit("_", 1)[-1] for p in d.iterdir())
        instants = [e for e in t.tracer().to_chrome_trace()["traceEvents"]
                    if e["name"] == "membership"]
        got[name] = (planned, len(caught), bundles,
                     [(e["args"]["event"], e["args"]["trace_id"]
                       == root.trace_id) for e in instants],
                     reg.snapshot())
        t.configure(enabled=None)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (0, 1, ["eviction.json"])
