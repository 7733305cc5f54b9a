"""The port's Router (deeplearning4j_tpu_torch/serving/router.py) and
Autoscaler (serving/autoscaler.py), with the registry's canary plumbing,
against the JAX package's on the same inputs and a fake clock.

Router: two zoo LeNet versions (the JAX networks' weights carried into
the port by interop) behind a registry and a Router in each package; the
same seeded requests and the same `evaluate(now=...)` ticks give the same
counter split (request n goes to the canary iff floor(n f) advanced), the
same ramp, promotion or rollback on the same tick, exactly one
`canary_rollback` bundle under `canary_nan`, and the same per-version
request counters. Answers agree with the JAX answers within 1e-5 absolute
(softmax rows of float32 convolutions summed in another order), and each
is that version's own output, so a request routed to the wrong version
(rows apart by far more) fails.

Autoscaler: replica stand-ins whose queue-depth and latency signals are
scripted per tick (the same stand-in class in both packages), so the same
script scales out and in on the same ticks under hysteresis, the dwell's
storm guard, a `replica_spawn` failure episode with seeded decorrelated
backoff, and a crashed replica's eviction and failover; then a real pool
(`Autoscaler.for_model` over a registered LeNet with a warm manifest)
behind the Router. No test sleeps through a real dwell window; every wait
is bounded.
"""
import json
import os
import random
import warnings

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.serving import autoscaler as jautoscaler
from deeplearning4j_tpu.serving import errors as jerrors
from deeplearning4j_tpu.serving import registry as jregistry
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu.serving.breaker import CircuitBreaker as JBreaker
from deeplearning4j_tpu.serving.buckets import BucketSpec as JBucketSpec
from deeplearning4j_tpu.telemetry import flight as jflight
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import slo as jslo
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving import (
    Autoscaler,
    DispatchFailedError,
    ModelRegistry,
    Router,
    fleet_section,
    submit_with_retry,
)
from deeplearning4j_tpu_torch.serving import autoscaler
from deeplearning4j_tpu_torch.serving import errors
from deeplearning4j_tpu_torch.serving import registry
from deeplearning4j_tpu_torch.serving import router
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.serving.buckets import BucketSpec
from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import slo
from deeplearning4j_tpu_torch.telemetry import trace
from test_torch_parallel import jax_net, port_net
from test_torch_telemetry import labelled_text, live_text

TOL = 1e-5
SIZES = (1, 2, 3)
# windows through rule_kwargs, as the JAX rollout tests pass them; the
# latency rules judge against the largest latency bucket (10 s), since a
# first request's wall time (JAX compiles its forward then) is not a
# property either router's split may depend on
RULES = dict(fast_window_s=60.0, slow_window_s=600.0,
             latency_threshold_s=10.0)
# (registry, router, autoscaler, errors, chaos, metrics, trace, slo,
#  flight, breaker, buckets) of each package
PACKAGES = {
    "jax": (jregistry, jrouter, jautoscaler, jerrors, jchaos, jmetrics,
            jtrace, jslo, jflight, JBreaker, JBucketSpec),
    "port": (registry, router, autoscaler, errors, chaos, metrics, trace,
             slo, flight, CircuitBreaker, BucketSpec)}


def _reset():
    for (_, _, _, _, c, m, t, s, _, _, _) in PACKAGES.values():
        c.reset_fault_points()
        m.registry().reset()
        t.configure(enabled=None)
        t.tracer().clear()
        s.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for k in ("DL4J_TPU_CHAOS", "DL4J_TPU_TELEMETRY", "DL4J_TPU_WARM_CACHE",
              "DL4J_TPU_AUTOTUNE", "DL4J_TPU_FLIGHT_KEEP"):
        monkeypatch.delenv(k, raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def lenets():
    """Two LeNet versions: (JAX v1, JAX v2, port v1, port v2)."""
    out = []
    for seed in (1, 2):
        conf = JLeNet(seed=seed).conf().to_json()
        jnet = jax_net("mln", conf)
        out.append((jnet, port_net("mln", conf, jnet)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _requests(n, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((SIZES[i % len(SIZES)], 28, 28, 1)).astype(
        np.float32) for i in range(n)]


def _fleets(lenets, stages, min_requests):
    """A registry of the two LeNet versions + a Router in each package;
    the canary's rollout started with the shrunk windows."""
    jv1, jv2, pv1, pv2 = lenets
    mesh = jbuild_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    made = {}
    for name, (reg_mod, rt_mod, *_rest, br, bs) in PACKAGES.items():
        reg = (reg_mod.ModelRegistry(mesh=mesh) if name == "jax"
               else reg_mod.ModelRegistry(device="cpu"))
        v1, v2 = (jv1, jv2) if name == "jax" else (pv1, pv2)
        for version, net, stable in (("v1", v1, True), ("v2", v2, False)):
            reg.register("m", net, version=version, stable=stable,
                         batch_limit=4, buckets=bs(4, sizes=(1, 2, 4)),
                         breaker=br(failure_threshold=1000))
        rt = rt_mod.Router(reg)
        ro = rt.start_rollout("m", "v2", stages=stages,
                              min_requests=min_requests, **RULES)
        made[name] = (reg, rt, ro)
    return made


def _which(out, x, nets):
    """The version whose own output this answer is (None: neither)."""
    for version, net in nets.items():
        ref = net.output(x).numpy()
        if np.abs(np.asarray(out) - ref).max() <= TOL:
            return version
    return None


def _drive(made, lenets, ticks, per_tick, start=1000.0):
    """The same requests and ticks in both packages; per tick the
    versions that answered, the rollout's state and the answers."""
    _, _, pv1, pv2 = lenets
    nets = {"v1": pv1, "v2": pv2}
    xs = _requests(ticks * per_tick)
    log = {name: [] for name in made}
    answers = {name: [] for name in made}
    for name, (reg, rt, ro) in made.items():
        rt.evaluate(now=start)
        now = start
        for k in range(ticks):
            versions = []
            for x in xs[k * per_tick:(k + 1) * per_tick]:
                try:
                    out = rt.output("m", x, deadline_s=30.0)
                except Exception as e:  # the typed serving errors
                    versions.append(type(e).__name__)
                    continue
                answers[name].append(np.asarray(out))
                versions.append(_which(out, x, nets))
            now += 61.0
            rows = rt.evaluate(now=now)
            log[name].append((versions, ro.state, ro.stage, list(
                ro.history), ro.canary_requests_in_stage,
                sorted(r["slo"] for r in rows if r["firing"])))
    return log, answers


def test_router_splits_ramps_and_promotes_on_the_same_ticks(lenets):
    made = _fleets(lenets, (0.25, 0.5, 1.0), 4)
    try:
        log, answers = _drive(made, lenets, ticks=5, per_tick=12)
        assert made["port"][0].get("m").version == "v2"
    finally:
        for reg, _, _ in made.values():
            reg.shutdown()
    assert log["port"] == log["jax"]
    first = log["port"][0][0]
    # floor(n f) at f = 0.25: requests 4, 8 and 12 of the first tick
    assert first == ["v1", "v1", "v1", "v2"] * 3
    assert log["port"][-1][1] == "promoted"
    assert log["port"][-1][3] == ["25", "50", "100", "promote"]
    for got, want in zip(answers["port"], answers["jax"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # this test's model only, gauges at 0 included: the promoted canary's
    # traffic fraction reads 0
    text = {name: labelled_text(m, (
        "dl4j_tpu_model_requests_total", "dl4j_tpu_canary_transitions_total",
        "dl4j_tpu_canary_traffic_fraction"), model="m")
        for name, (_, _, _, _, _, m, *_rest) in PACKAGES.items()}
    assert text["port"] == text["jax"]
    assert 'dl4j_tpu_canary_traffic_fraction{model="m"} 0' in text["port"]


def test_nan_canary_rolls_back_in_one_tick_with_one_bundle(
        lenets, monkeypatch, tmp_path):
    """canary_nan on every canary batch: the per-version availability
    rule fires and the rollout rolls back in the tick that sees it, in
    both packages; exactly one canary_rollback bundle each, which the
    other package reads; the stable answers never change."""
    monkeypatch.setenv("DL4J_TPU_CHAOS", "canary_nan@" + ":".join(
        str(i) for i in range(1, 60)))
    for (_, _, _, _, c, _, t, *_rest) in PACKAGES.values():
        c.reset_fault_points()
        t.configure(enabled=True)
    made = _fleets(lenets, (0.5, 1.0), 50)
    bundles = {}
    try:
        log, answers = _drive(made, lenets, ticks=3, per_tick=8)
        for name, (reg, rt, ro) in made.items():
            bundles[name] = ro.rollback_bundle
            # after the rollback 100% stable, the schedule untouched
            x = _requests(1, seed=9)[0]
            assert _which(rt.output("m", x), x,
                          {"v1": lenets[2], "v2": lenets[3]}) == "v1"
            assert rt.rollout_status("m")[0]["rollback_bundle"]
    finally:
        for reg, _, _ in made.values():
            reg.shutdown()
    assert log["port"] == log["jax"]
    versions, state, _, history, _, firing = log["port"][0]
    assert state == "rolled_back" and history == ["50", "rollback"]
    assert versions.count("NonFiniteOutputError") == 4
    assert "serving_availability:m:v2" in firing
    assert all(s == "rolled_back" for _, s, *_rest in log["port"])
    assert sorted(p for p in os.listdir(tmp_path / "flight")
                  if "canary_rollback" in p) == sorted(
        os.path.basename(p) for p in bundles.values())
    pdoc = jflight.load_bundle(bundles["port"])
    jdoc = flight.load_bundle(bundles["jax"])
    for doc in (pdoc, jdoc):
        assert doc["reason"] == "canary_rollback"
        assert doc["canary"]["canary"] == "v2"
        assert doc["canary"]["stage_percent"] == 50
        assert len(doc["canary"]["offending_traces"]) == 4
    assert sorted(pdoc["canary"]) == sorted(jdoc["canary"])


def test_canary_points_armed_only_while_canary_and_autotune_raises(
        lenets, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_CHAOS", "canary_dispatch@1")
    chaos.reset_fault_points()
    reg = ModelRegistry(device="cpu")
    try:
        mv = reg.register("m", lenets[2], batch_limit=4)
        x = _requests(1)[0]
        reg.warm("m", example=x)  # consumes nothing
        mv.server.output(x)       # stable traffic: schedule untouched
        assert mv.dispatch is not None and mv.server_kwargs == {
            "batch_limit": 4}
        mv.canary = True
        assert mv.snapshot()["canary"] is True
        with pytest.raises(DispatchFailedError):
            mv.server.output(x)   # the 1st CANARY batch fires
        mv.canary = False
        assert mv.server.output(x).shape == (1, 10)
        rt = Router(reg)
        rt.evaluate(now=1.0)
        monkeypatch.setenv("DL4J_TPU_AUTOTUNE", "1")
        with pytest.raises(NotImplementedError, match="tuner"):
            rt.evaluate(now=2.0)
    finally:
        reg.shutdown()


# ===========================================================================
# autoscaler
# ===========================================================================


class _Load:
    """The scripted signals every stand-in replica reports."""

    def __init__(self):
        self.depth, self.ema = 0, None


def _stub_factory(errors_mod, load, crashed):
    """Replica stand-ins: snapshot() reports `load`; a replica whose name
    is in `crashed` has a dead dispatcher."""

    class Stub:
        def __init__(self, name):
            self.name, self.stopped = name, False

        @property
        def crashed(self):
            return self.name in crashed

        def snapshot(self):
            return {"name": self.name, "queue_depth": load.depth,
                    "queue_depth_p50": None, "ema_latency_s": load.ema}

        def output(self, x, deadline_s=None, tenant=None):
            if self.crashed:
                raise errors_mod.DispatcherCrashedError("dispatcher died")
            return np.asarray([self.name])

        def shutdown(self, timeout=5.0):
            self.stopped = True

    return lambda name, tenancy: Stub(name)


# per tick: (queue depth, EMA latency s, replicas to crash, requests)
SCRIPT = [(0, None, (), 2), (12, 0.01, (), 3), (12, 0.01, (), 3),
          (12, 0.01, (), 3), (12, 0.3, (), 3), (12, 0.3, (), 3),
          (12, 0.3, ("fleet-r2",), 4), (0, 0.01, (), 3), (0, 0.01, (), 3),
          (0, None, (), 2), (0, None, (), 2), (0, None, (), 2),
          (3, 0.1, (), 2), (0, None, (), 2)]


def _autoscale_run(pkg, monkeypatch, tmp_path):
    (_, rt_mod, as_mod, err_mod, c, m, t, _, fl, _, _) = pkg
    monkeypatch.setenv("DL4J_TPU_CHAOS", "replica_spawn@3:4")
    c.reset_fault_points()
    load, crashed = _Load(), set()
    pool = as_mod.Autoscaler(
        _stub_factory(err_mod, load, crashed), min_replicas=1,
        max_replicas=3, queue_depth_high=8.0, queue_depth_low=1.0,
        ema_high_s=0.25, ema_low_s=0.05, min_dwell_s=5.0,
        spawn_backoff_base_s=1.0, spawn_backoff_cap_s=4.0,
        clock=lambda: 0.0, rng=random.Random(3))
    ticks = []
    try:
        for k, (depth, ema, crash, n) in enumerate(SCRIPT):
            now = 2.0 * (k + 1)
            load.depth, load.ema = depth, ema
            crashed.update(crash)
            served = [str(pool.output(np.ones(1))[0]) for _ in range(n)]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                action = pool.evaluate(now=now)
            snap = pool.snapshot(now=now)
            ticks.append((action, snap["replicas_live"],
                          snap["storm_guard_active"], snap["spawn"],
                          served, sorted(r["replica_id"] for r in
                                         snap["replica_servers"])))
        events = pool.snapshot()["events"]
        membership = pool.membership.snapshot()
    finally:
        pool.shutdown()
    text = live_text(m, (
        "dl4j_tpu_fleet_scale_events_total", "dl4j_tpu_fleet_replicas",
        "dl4j_tpu_membership_transitions_total",
        "dl4j_tpu_chaos_injections_total"))
    return ticks, events, membership, text, pool.snapshot()["replicas_live"]


def test_autoscaler_scales_on_the_same_ticks(monkeypatch, tmp_path):
    got = {name: _autoscale_run(pkg, monkeypatch, tmp_path)
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    ticks, events, membership, text, live = got["port"]
    actions = [a for a, *_ in ticks]
    assert actions.count("out") >= 2 and "in" in actions
    assert any(spawn["episode_open"] for _, _, _, spawn, *_ in ticks)
    assert any(guard for _, _, guard, *_ in ticks)  # the dwell held
    # the crashed replica was reaped and its callers answered by others
    assert any(e["reason"] == "crash" for e in events)
    assert all("fleet-r2" not in served for *_, served, _ in ticks[6:])
    assert 'reason="spawn_retry"' in text and live == 0


def test_crash_failover_and_spawn_bundles_with_telemetry_on(monkeypatch,
                                                            tmp_path):
    """Gate on: the spawn-failure episode writes ONE replica_spawn bundle
    and the crash one eviction bundle, in both packages; replicas become
    fleet sources."""
    got = {}
    for name, pkg in PACKAGES.items():
        pkg[6].configure(enabled=True)
        d = tmp_path / name
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(d))
        ticks, *_ = _autoscale_run(pkg, monkeypatch, tmp_path)
        kinds = sorted(p.rsplit("_", 1)[-1] for p in os.listdir(d))
        got[name] = (ticks, kinds)
        pkg[6].configure(enabled=None)
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["eviction.json", "spawn.json"]


def test_pool_for_model_behind_the_router_warms_from_the_manifest(
        lenets, tmp_path):
    """A real pool: Autoscaler.for_model over a registered LeNet whose
    warm manifest was recorded; spawned replicas warm every bucket from
    it, answer as net.output, and the Router routes the model's name
    (and submit_with_retry's model=) through the pool."""
    net = lenets[2]
    reg = ModelRegistry(warm_cache_dir=str(tmp_path / "warm"), device="cpu")
    pool = None
    try:
        reg.register("m", net, batch_limit=4)
        reg.register("m", lenets[3], version="v2", stable=False,
                     batch_limit=4)
        reg.warm("m", example=_requests(1)[0])
        rt = Router(reg)
        pool = Autoscaler.for_model(reg, "m", min_replicas=1,
                                    max_replicas=2, queue_depth_high=-1.0,
                                    min_dwell_s=0.0, clock=lambda: 0.0)
        rt.attach_autoscaler("m", pool)
        with pytest.raises(ValueError):
            rt.start_rollout("m", "v2")
        assert rt.evaluate(now=1.0) == []  # drives the pool: scale out
        snap = pool.snapshot()
        assert snap["replicas_live"] == 2
        for rep in pool._replicas:
            assert sorted(b for _, b in rep.server.warmed_rows) == [1, 2, 4]
        xs = _requests(6)
        outs = [rt.output("m", x, tenant="acme") for x in xs]
        outs.append(submit_with_retry(rt, xs[0], model="m",
                                      request_deadline_s=30.0))
        for out, x in zip(outs, xs + xs[:1]):
            np.testing.assert_allclose(out, net.output(x).numpy(), rtol=0,
                                       atol=TOL)
        assert rt.snapshot()["fleets"]["m"]["replicas_live"] == 2
        assert fleet_section()["replicas"] >= 2
        assert router.models_section() is not None
        rt.detach_autoscaler("m")
        rt.start_rollout("m", "v2", stages=(1.0,), min_requests=1)
        with pytest.raises(ValueError):
            rt.attach_autoscaler("m", pool)
        json.dumps(rt.snapshot(), default=str)
    finally:
        if pool is not None:
            pool.shutdown()
        reg.shutdown()
