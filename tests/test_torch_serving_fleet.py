"""The port's serving fleet (deeplearning4j_tpu_torch/serving/: tenancy,
warmstart, registry, client, the runtime's mesh dispatch, tenant queues,
bucket re-cut and healthz; util/locks.py; distributed/continuous.py's
readers) against the JAX package's on the same inputs.

Control-plane parity is exact: the same arrivals on a fake clock give the
same admit, shed and dequeue sequence and the same retry hints in both
packages; a warm manifest is the same bytes whichever package wrote it;
the same lock orders give the same inversion events; the same seeded
retry loop sleeps the same delays. Answers of networks resolved from
either package's files agree within 1e-5 of their largest magnitude
(float32 sums in another order). The JAX registry is built without a
warm-cache directory (its `enable` points JAX's process-wide compilation
cache there); manifests cross through the warmstart functions. Every
wait is bounded.
"""
import os
import random
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.distributed import continuous as jcontinuous
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.resilience.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from deeplearning4j_tpu.serving import client as jclient
from deeplearning4j_tpu.serving import errors as jerrors
from deeplearning4j_tpu.serving import registry as jregistry
from deeplearning4j_tpu.serving import runtime as jruntime
from deeplearning4j_tpu.serving import tenancy as jtenancy
from deeplearning4j_tpu.serving import warmstart as jwarm
from deeplearning4j_tpu.serving.breaker import CircuitBreaker as JBreaker
from deeplearning4j_tpu.serving.buckets import BucketSpec as JBucketSpec
from deeplearning4j_tpu.util import locks as jlocks
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.distributed import continuous
from deeplearning4j_tpu_torch.resilience.retry import Deadline
from deeplearning4j_tpu_torch.serving import (
    BucketSpec,
    CircuitBreaker,
    DispatchFailedError,
    InferenceServer,
    ModelRegistry,
    ShedError,
    TenantQuotaError,
    healthz_section,
    resolve_model,
    submit_with_retry,
    warmstart,
)
from deeplearning4j_tpu_torch.serving import tenancy
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.util import locks
from test_torch_parallel import jax_net, port_net

KERAS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "fixtures", "keras_ref", "tfscope", "model.h5")
REL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("DL4J_TPU_WARM_CACHE", "DL4J_TPU_SERVING", "DL4J_TPU_CHAOS",
              "DL4J_TPU_LOCKCHECK"):
        monkeypatch.delenv(k, raising=False)


def _until_taken(server, seconds=10.0):
    """Waits (bounded) until the server's dispatcher has taken every
    queued request."""
    dl = Deadline(seconds)
    while len(server._q) and not dl.expired:
        time.sleep(0.001)
    assert not len(server._q)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


# ---------------------------------------------------------------- tenancy
class _Req:
    def __init__(self, i, tenant, n):
        self.i, self.tenant, self.n = i, tenant, n


# (time, tenant, rows): tenant "a" bursts past its quota, "b" trickles,
# "c" (the default policy) arrives late with a request over its burst
ARRIVALS = ([(0.0, "a", 4)] * 6 + [(0.0, "b", 2)] * 3 + [(0.1, "a", 8),
            (0.15, "b", 5), (0.5, "a", 4), (0.5, "c", 30), (0.6, "c", 1),
            (0.9, "b", 1), (2.0, "a", 16), (2.0, "a", 1)])


def _tenancy_run(mod):
    """The arrivals through mod's TenancyController and TenantQueue: the
    admit / shed outcomes with their hints, pops interleaved after every
    third arrival and the rest drained, and the final snapshot."""
    now = [0.0]
    ctrl = mod.TenancyController(default_rate=10.0, default_burst=20.0,
                                 quantum=4, clock=lambda: now[0])
    ctrl.add_tenant("a", rate=16.0, burst=16.0, weight=3.0)
    ctrl.add_tenant("b", rate=4.0, weight=1.0)
    q = ctrl.make_queue(64)
    seen, popped = [], []
    for i, (t, tenant, rows) in enumerate(ARRIVALS):
        now[0] = t
        try:
            name = ctrl.admit(tenant, rows=rows)
        except mod.TenantQuotaError as e:
            seen.append(("shed", tenant, e.tenant, e.retry_after_s))
        else:
            seen.append(("ok", name))
            q.append(_Req(i, name, rows))
        if i % 3 == 2 and q:
            assert q[0] is q[0]
            head = q[0]
            popped.append(q.popleft().i)
            assert popped[-1] == head.i  # the peek is the pop
    while q:
        popped.append(q.popleft().i)
    ctrl.observe("a", "ok", latency_s=0.25)
    ctrl.note_shed("b", "queue_full")
    return seen, popped, ctrl.snapshot(), q.queued_by_tenant()


def test_tenancy_admits_sheds_and_dequeues_as_jax():
    got, want = _tenancy_run(tenancy), _tenancy_run(jtenancy)
    assert got == want
    seen, popped, snap, _ = got
    assert any(s[0] == "shed" for s in seen)
    assert sorted(popped) == [i for i, s in enumerate(seen) if s[0] == "ok"]
    assert snap["tenants"]["a"]["latency_p50_s"] == 0.25
    assert issubclass(TenantQuotaError, ShedError)


def _weighted_order(runtime_mod, tenancy_mod, bucket_spec, breaker):
    """Two tenants (weights 3:1) backlogged behind a held dispatch on a
    server of batch_limit 1: the order the dispatcher serves them in,
    and the quota refusals of a third tenant."""
    gate = threading.Event()
    order = []

    def dispatch(xp):
        gate.wait(10.0)
        order.append(int(xp[0, 0]))
        return np.asarray(xp, np.float32)

    ctrl = tenancy_mod.TenancyController(default_rate=1000.0, quantum=1)
    ctrl.add_tenant("heavy", weight=3.0)
    ctrl.add_tenant("light", weight=1.0)
    ctrl.add_tenant("capped", rate=0.001, burst=2.0)
    server = runtime_mod.InferenceServer(
        dispatch=dispatch, batch_limit=1, queue_limit=64, wait_ms=0.0,
        buckets=bucket_spec(1, sizes=(1,)), breaker=breaker(1000),
        tenancy=ctrl, name="tenants")
    try:
        first = server.submit(np.full((1, 1), -1.0, np.float32),
                              tenant="light")
        _until_taken(server)  # the dispatcher holds `first`
        reqs = []
        for i in range(8):
            reqs.append(server.submit(np.full((1, 1), i, np.float32),
                                      tenant="heavy"))
            reqs.append(server.submit(np.full((1, 1), 100 + i, np.float32),
                                      tenant="light"))
        quota = 0
        for _ in range(4):
            try:
                reqs.append(server.submit(np.full((1, 1), 200, np.float32),
                                          tenant="capped"))
            except tenancy_mod.TenantQuotaError:
                quota += 1
        gate.set()
        for r in [first] + reqs:
            server.result(r)
        snap = server.snapshot()
    finally:
        gate.set()
        server.shutdown()
    return order, quota, server.observed_rows(), snap["queued_by_tenant"]


def test_weighted_queue_serves_tenants_as_jax():
    got = _weighted_order(__import__(
        "deeplearning4j_tpu_torch.serving.runtime", fromlist=["x"]),
        tenancy, BucketSpec, lambda n: CircuitBreaker(failure_threshold=n))
    want = _weighted_order(jruntime, jtenancy, JBucketSpec,
                           lambda n: JBreaker(failure_threshold=n))
    assert got == want
    order, quota = got[0], got[1]
    # three heavy rows per light row while both are backlogged (light
    # comes first: its sub-queue was made first; capped's two admitted
    # rows take their turns between)
    assert [v for v in order[1:] if v != 200][:8] == [100, 0, 1, 2, 101, 3,
                                                      4, 5]
    assert quota == 2


# ---------------------------------------------------------------- runtime
def _echo(xp):
    return np.asarray(xp, np.float32) * 2.0


def _recut_run(runtime_mod, bucket_spec, breaker):
    seen = []

    def dispatch(xp):
        seen.append(xp.shape[0])
        return _echo(xp)

    server = runtime_mod.InferenceServer(
        dispatch=dispatch, batch_limit=8, wait_ms=0.0,
        buckets=bucket_spec(8, sizes=(4, 8)), breaker=breaker(1000),
        name="recut")
    try:
        server.warmup(np.ones((1, 3), np.float32))
        for n in (1, 3, 5):
            server.output(np.ones((n, 3), np.float32), deadline_s=10.0)
        spec = server.recut_buckets([1, 2, 8])
        server.output(np.ones((2, 3), np.float32), deadline_s=10.0)
        section = [s for s in (runtime_mod.healthz_section() or
                               {"servers": []})["servers"]
                   if s["name"] == "recut"]
        snap = {k: v for k, v in section[0].items()
                if not k.startswith(("latency", "ema"))}
        return (seen, spec.sizes, server.observed_rows(),
                sorted(server.warmed_rows), sorted(server.dispatched_rows),
                snap)
    finally:
        server.shutdown()


def test_recut_buckets_and_healthz_section_as_jax():
    got = _recut_run(__import__("deeplearning4j_tpu_torch.serving.runtime",
                                fromlist=["x"]), BucketSpec,
                     lambda n: CircuitBreaker(failure_threshold=n))
    want = _recut_run(jruntime, JBucketSpec,
                      lambda n: JBreaker(failure_threshold=n))
    assert got == want
    assert got[1] == (1, 2, 8)
    assert got[2] == [1, 3, 5, 2]  # the warmup's batches are not demand


def test_healthz_section_lists_live_servers_only():
    server = InferenceServer(dispatch=_echo, batch_limit=4, name="hz")
    try:
        section = healthz_section()
        assert [s for s in section["servers"] if s["name"] == "hz"]
        assert section["breaker_open"] in (False, True)
    finally:
        server.shutdown()
    section = healthz_section()
    assert section is None or not [s for s in section["servers"]
                                   if s["name"] == "hz"]


# ---------------------------------------------------------------- locks
def _inversions(mod):
    mod.reset_for_tests()
    a, b = mod.TrackedLock("site.a"), mod.TrackedRLock("site.b")
    with a:
        with b:
            pass
    with b:
        with b:  # re-entry is order-neutral
            with a:
                pass
    cond = threading.Condition(mod.TrackedRLock("site.c"))
    with cond:
        cond.wait(0.001)
    return [(e["site"], e["against"]) for e in mod.inversions()]


def test_tracked_lock_reports_an_inversion_as_jax(monkeypatch):
    raw = type(threading.Lock())
    assert type(locks.TrackedLock("off")) is raw
    monkeypatch.setenv("DL4J_TPU_LOCKCHECK", "1")
    monkeypatch.setenv("DL4J_TPU_LOCKCHECK_HOLD_S", "0.0")
    try:
        got, want = _inversions(locks), _inversions(jlocks)
        assert got == want == [("site.a", "site.b")]
        assert isinstance(locks.TrackedLock("on"), locks.TrackedLock)
        assert metrics.registry().get("dl4j_tpu_lock_long_holds_total"
                                      ).labels("site.a").value >= 1
    finally:
        locks.reset_for_tests()
        jlocks.reset_for_tests()


# ---------------------------------------------------------------- warmstart
def test_warm_manifests_cross_both_ways(tmp_path):
    d = str(tmp_path)
    x = np.zeros((4, 28, 28, 1), np.float32)
    ids = np.zeros((2, 16), np.int32)
    a = warmstart.record_warm(d, "model/with:odd chars", "v1.2", x, (1, 8))
    b = jwarm.record_warm(str(tmp_path / "jax"), "model/with:odd chars",
                          "v1.2", x, (8, 1))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert os.path.basename(a) == os.path.basename(b)
    jwarm.record_warm(d, "lm", "v2", ids, (16, 4))
    for mod in (warmstart, jwarm):
        m = mod.load_manifest(d, "model/with:odd chars", "v1.2")
        assert m["row_shape"] == [28, 28, 1] and m["buckets"] == [1, 8]
        lm = mod.load_manifest(d, "lm", "v2")
        ex = mod.warmup_example(lm)
        assert ex.shape == (1, 16) and ex.dtype == np.int32
        assert mod.load_manifest(d, "lm", "v9") is None
    assert warmstart.list_manifests(d) == jwarm.list_manifests(d)
    assert warmstart._slug("a/b c") == jwarm._slug("a/b c") == "a_b_c"
    assert warmstart.enable(str(tmp_path / "new")) == str(tmp_path / "new")


# ---------------------------------------------------------------- registry
def _register(reg, name="m", version="v1", **kw):
    kw.setdefault("breaker", CircuitBreaker(failure_threshold=1000))
    kw.setdefault("batch_limit", 8)
    kw.setdefault("buckets", BucketSpec(8, sizes=(1, 8)))
    return reg.register(name, dispatch=_echo, version=version, **kw)


def test_registry_versions_stable_snapshot_and_isolation():
    reg = ModelRegistry(device="cpu")
    try:
        _register(reg, "m", "v1")
        _register(reg, "m", "v2", stable=False)
        _register(reg, "other", "v1")
        assert reg.models() == ["m", "other"]
        assert reg.get("m").version == "v1"
        assert reg.get("m", "v2").key == "m:v2"
        reg.set_stable("m", "v2")
        assert reg.get("m").version == "v2"
        snap = reg.snapshot()
        assert snap["models"]["m"]["stable"] == "v2"
        assert [v["version"] for v in
                snap["models"]["m"]["versions"]] == ["v1", "v2"]
        with pytest.raises(ValueError):
            _register(reg, "m", "v2")  # duplicate
        with pytest.raises(KeyError):
            reg.get("nope")

        def boom(xp):
            raise RuntimeError("broken model")

        reg.register("bad", dispatch=boom,
                     breaker=CircuitBreaker(failure_threshold=1000),
                     buckets=BucketSpec(8, sizes=(1, 8)))
        with pytest.raises(DispatchFailedError):
            reg.get("bad").server.output(np.ones((1, 2), np.float32))
        assert reg.get("other").server.output(
            np.ones((1, 2), np.float32)).shape == (1, 2)
        reg.unregister("m", "v2")
        assert reg.get("m").version == "v1"  # the survivor is stable
        reg.unregister("m")
        assert reg.models() == ["bad", "other"]
        assert reg in __import__(
            "deeplearning4j_tpu_torch.serving.registry",
            fromlist=["x"]).live_registries()
    finally:
        reg.shutdown()
    assert reg.models() == []


def test_registry_warms_from_its_manifest_alone(tmp_path):
    reg = ModelRegistry(device="cpu")
    try:
        _register(reg, "m")
        with pytest.raises(ValueError):
            reg.warm("m")  # no cache dir
    finally:
        reg.shutdown()
    d = str(tmp_path / "wc")
    reg = ModelRegistry(warm_cache_dir=d, device="cpu")
    try:
        mv = _register(reg, "m")
        with pytest.raises(FileNotFoundError):
            reg.warm("m")  # no manifest yet
        assert reg.replica_example(mv) is None
        reg.warm("m", example=np.ones((3, 5), np.float32))
        assert sorted(mv.server.warmed_rows)[0][1] == 1
    finally:
        reg.shutdown()
    reg2 = ModelRegistry(warm_cache_dir=d, device="cpu")
    try:
        mv2 = _register(reg2, "m")
        reg2.warm("m")  # the manifest alone
        assert {b for _, b in mv2.server.warmed_rows} == {1, 8}
        assert reg2.replica_example(mv2).shape == (1, 5)
        assert jwarm.load_manifest(d, "m", "v1")["row_shape"] == [5]
    finally:
        reg2.shutdown()


@pytest.fixture(scope="module")
def lenet_files(tmp_path_factory):
    """JAX LeNet written as a checkpoint zip and as a CheckpointManager
    publication (checkpoint + latest pointer), beside its answers."""
    base = tmp_path_factory.mktemp("sources")
    conf = JLeNet().conf().to_json()
    jnet = jax_net("mln", conf)
    x = np.random.default_rng(9).standard_normal(
        (3, 28, 28, 1)).astype(np.float32)
    zip_path = str(base / "lenet.zip")
    jser.write_model(jnet, zip_path)
    pub = str(base / "pub")
    mgr = JCheckpointManager(pub)
    mgr.save(jnet, step=7)
    jcontinuous.write_latest_pointer(pub, mgr.manifest(7))
    return zip_path, pub, x, np.asarray(jnet.output(x)), conf, jnet


def test_resolve_model_answers_as_jax_for_every_source(lenet_files,
                                                        tmp_path):
    zip_path, pub, x, want, conf, jnet = lenet_files
    for source in (zip_path, pub):
        net = resolve_model(source, device="cpu")
        _close(net.output(x).numpy(), want)
        _close(net.output(x).numpy(),
               np.asarray(jregistry.resolve_model(source).output(x)))
    kx = np.random.default_rng(3).standard_normal((4, 70)).astype(
        np.float32)
    _close(resolve_model(KERAS, device="cpu").output(kx).numpy(),
           np.asarray(jregistry.resolve_model(KERAS).output(kx)))
    zoo = resolve_model("zoo:LeNet", device="cpu")
    assert zoo.conf.to_json() == port_net("mln", conf, jnet).conf.to_json()
    assert zoo.output(x).shape == (3, 10)
    sentinel = object()
    assert resolve_model(sentinel) is sentinel
    for bad in ("zoo:NoSuchModel", "not-a-source"):
        with pytest.raises(ValueError):
            resolve_model(bad)
    ptr = continuous.read_latest_pointer(pub)
    assert ptr == jcontinuous.read_latest_pointer(pub) and ptr["step"] == 7
    assert continuous.read_latest_pointer(str(tmp_path)) is None


def test_torn_publish_is_refused_in_both(lenet_files, tmp_path):
    """A publication whose zip no longer matches its manifest's sha256
    raises IOError before any network is built, in both packages."""
    _, pub, *_ = lenet_files
    torn = tmp_path / "torn"
    torn.mkdir()
    for name in os.listdir(pub):
        data = open(os.path.join(pub, name), "rb").read()
        if name.endswith(".zip"):
            data = data[:len(data) // 2] + bytes(len(data) - len(data) // 2)
        (torn / name).write_bytes(data)
    with pytest.raises(IOError):
        resolve_model(str(torn), device="cpu")
    with pytest.raises(IOError):
        jregistry.resolve_model(str(torn))
    with pytest.raises(ValueError, match="no published"):
        continuous.load_published_model(str(tmp_path / "empty"),
                                        device="cpu")


def test_registry_serves_sources_side_by_side(lenet_files):
    zip_path, pub, x, want, *_ = lenet_files
    reg = ModelRegistry(device="cpu")
    try:
        reg.register("zip", zip_path, batch_limit=4)
        reg.register("pub", pub, batch_limit=4)
        reg.register("zoo", "zoo:LeNet", batch_limit=4)
        for name in ("zip", "pub"):
            _close(reg.get(name).server.output(x, deadline_s=30.0), want)
        out = reg.get("zoo").server.output(x, deadline_s=30.0)
        _close(out, reg.get("zoo").server.model.output(x).numpy())
        assert reg.get("zip").server.buckets.sizes == (1, 2, 4)
    finally:
        reg.shutdown()


# ---------------------------------------------------------------- client
class _FlakyServer:
    """Sheds `fail_n` times (with a retry_after_s hint), then answers."""

    def __init__(self, fail_n, exc=ShedError, hint=None):
        self.fail_n, self.exc, self.hint = fail_n, exc, hint
        self.calls = 0

    def output(self, x, deadline_s=None):
        self.calls += 1
        if self.calls <= self.fail_n:
            if self.hint is not None:
                raise self.exc("refused", retry_after_s=self.hint)
            raise self.exc("refused")
        return np.asarray(x) * 10.0


@pytest.mark.parametrize("case", ["shed", "hint", "quota", "exhausted",
                                  "non_transient", "deadline"])
def test_submit_with_retry_as_jax(case):
    """The same refusals and seed: the same calls, sleeps and outcome in
    both packages (each package's own error classes)."""

    def run(client, errors):
        exc, fail_n, kw = {
            "shed": (errors.ShedError, 2, {}),
            "hint": (errors.CircuitOpenError, 2, {}),
            "quota": (errors.TenantQuotaError, 3, {}),
            "exhausted": (errors.ShedError, 99, {"attempts": 3}),
            "non_transient": (errors.DispatchFailedError, 5, {}),
            "deadline": (errors.ShedError, 99, {"attempts": 50,
                                                "deadline_s": 0.0}),
        }[case]
        hint = 1.7 if case in ("hint", "deadline") else None
        if case == "quota":
            hint = 0.3
        srv = _FlakyServer(fail_n, exc=exc, hint=hint)
        sleeps = []
        try:
            out = client.submit_with_retry(srv, np.ones(2),
                                           sleep=sleeps.append,
                                           rng=random.Random(7), **kw)
            result = float(out[0])
        except errors.ServingError as e:
            result = type(e).__name__
        return srv.calls, sleeps, result

    got = run(__import__("deeplearning4j_tpu_torch.serving.client",
                         fromlist=["x"]),
              __import__("deeplearning4j_tpu_torch.serving.errors",
                         fromlist=["x"]))
    assert got == run(jclient, jerrors)
    calls, sleeps, result = got
    if case in ("shed", "hint", "quota"):
        assert result == 10.0 and len(sleeps) == calls - 1
    if case == "hint":
        assert all(s >= 1.7 for s in sleeps)
    if case == "non_transient":
        assert calls == 1 and not sleeps


def test_submit_with_retry_through_a_shedding_server():
    """A real server whose queue is full sheds with a hint; the client
    rides it out once the held dispatch frees the queue."""
    gate = threading.Event()

    def dispatch(xp):
        gate.wait(10.0)
        return _echo(xp)

    server = InferenceServer(dispatch=dispatch, batch_limit=1,
                             queue_limit=1, wait_ms=0.0,
                             buckets=BucketSpec(1, sizes=(1,)))
    try:
        held = server.submit(np.ones((1, 2), np.float32))
        _until_taken(server)
        queued = server.submit(np.ones((1, 2), np.float32))
        with pytest.raises(ShedError):
            server.output(np.ones((1, 2), np.float32))
        sleeps = []

        def sleep(s):
            # the hinted wait: the held dispatch is let go and the queue
            # drains (bounded)
            sleeps.append(s)
            gate.set()
            _until_taken(server)

        out = submit_with_retry(server, np.full((1, 2), 3.0, np.float32),
                                sleep=sleep, request_deadline_s=10.0,
                                rng=random.Random(1))
        np.testing.assert_array_equal(out, np.full((1, 2), 6.0))
        assert len(sleeps) >= 1
        server.result(held), server.result(queued)
    finally:
        gate.set()
        server.shutdown()
    # model= routes by name through a Router (passed as the server)
    from deeplearning4j_tpu_torch.serving import Router

    reg = ModelRegistry(device="cpu")
    try:
        reg.register("m", dispatch=_echo, batch_limit=2,
                     buckets=BucketSpec(2, sizes=(1, 2)))
        out = submit_with_retry(Router(reg), np.ones((2, 2), np.float32),
                                model="m", request_deadline_s=10.0,
                                rng=random.Random(1))
        np.testing.assert_array_equal(out, np.full((2, 2), 2.0))
    finally:
        reg.shutdown()
