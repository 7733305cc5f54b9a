"""The port's telemetry core (deeplearning4j_tpu_torch/telemetry/: context,
metrics, trace, slo, flight, export, aggregate, health's metrics) against the
JAX package's on the same inputs and a fake clock.

Exact parity: the same metric operations render byte-identical Prometheus
text; every family the port registers has the JAX family's name, type,
help, labels and buckets; the same spans give Chrome traces with the same
names, args and nesting (timestamps, pids, thread ids and the random span
ids aside); the same rules over the same counts give the same SLO status
rows and episodes; the same frames give the same fleet merge and the same
drop, duplicate and late counters; each package's `load_bundle` and
`summarize` read the other's flight bundles. The only tolerance is the one
stated where a wall-clock duration is compared (none is). Both packages'
process-global registries, tracers, SLO engines, collectors and chaos
counters are reset around every test, since the metric names are shared.
"""
import json
import os
import re

import numpy as np
import pytest

from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.serving import autoscaler as jautoscaler  # noqa: F401
from deeplearning4j_tpu.serving import client as jclient  # noqa: F401
from deeplearning4j_tpu.serving import router as jrouter  # noqa: F401
from deeplearning4j_tpu.serving import runtime as jruntime
from deeplearning4j_tpu.serving import tenancy as jtenancy  # noqa: F401
from deeplearning4j_tpu.serving.buckets import BucketSpec as JBucketSpec
from deeplearning4j_tpu.serving.breaker import CircuitBreaker as JBreaker
from deeplearning4j_tpu.telemetry import aggregate as jagg
from deeplearning4j_tpu.telemetry import context as jcontext
from deeplearning4j_tpu.telemetry import export as jexport
from deeplearning4j_tpu.telemetry import flight as jflight
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import slo as jslo
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu.distributed import membership as jmembership  # noqa: F401
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving import autoscaler  # noqa: F401
from deeplearning4j_tpu_torch.serving import client  # noqa: F401
from deeplearning4j_tpu_torch.serving import router  # noqa: F401
from deeplearning4j_tpu_torch.serving import runtime
from deeplearning4j_tpu_torch.serving import tenancy  # noqa: F401
from deeplearning4j_tpu_torch.serving.buckets import BucketSpec
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.telemetry import aggregate as agg
from deeplearning4j_tpu_torch.telemetry import context
from deeplearning4j_tpu_torch.telemetry import export
from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import slo
from deeplearning4j_tpu_torch.telemetry import trace
from deeplearning4j_tpu_torch.distributed import membership  # noqa: F401
from deeplearning4j_tpu_torch.util import locks  # noqa: F401

# (metrics, trace, slo, chaos, aggregate, export) of each package
PACKAGES = {"jax": (jmetrics, jtrace, jslo, jchaos, jagg, jexport),
            "port": (metrics, trace, slo, chaos, agg, export)}


def live_text(m, names):
    """The families' Prometheus text without counter series still at 0: a
    registry reset zeroes a counter's children but keeps them, so a series
    that only one package's earlier test (in the same worker) created
    reads 0 in that package alone."""
    out = []
    for n in names:
        fam = m.registry().get(n)
        out += [line for line in fam.render()
                if fam.typename != "counter" or line.startswith("#")
                or not line.endswith(" 0")]
    return "\n".join(out)


def _has_labels(got, labels):
    """Whether the label dict ``got`` matches every ``key=value`` or
    ``key=(v1, v2)`` of ``labels``."""
    return all(got.get(k) in (v if isinstance(v, tuple) else (v,))
               for k, v in labels.items())


def labelled_text(m, names, **labels):
    """The families' Prometheus text restricted to the series whose labels
    a test created itself (``key=value`` or ``key=(v1, v2)``), gauges at 0
    included. A reset keeps a family's children at 0, so another test in
    the same worker may have left series of these very labels in one
    package's registry alone: a counter series at 0 is left out, since
    after a reset it reads the same as one never made."""
    out = []
    for n in names:
        fam = m.registry().get(n)
        for line in fam.render():
            if line.startswith("#"):
                out.append(line)
                continue
            series, value = line.rsplit(" ", 1)
            if fam.typename == "counter" and float(value) == 0:
                continue
            if _has_labels(dict(re.findall(r'(\w+)="([^"]*)"', series)),
                           labels):
                out.append(line)
    return "\n".join(out)


def own_series(snapshot, **labels):
    """A labelled counter family's snapshot restricted to the series whose
    labels match ``labels`` and whose count is not 0 (see
    ``labelled_text``)."""
    return {key: value for key, value in snapshot.items() if value and
            _has_labels(dict(kv.split("=", 1) for kv in key.split(",")),
                        labels)}


def _reset_all():
    for m, t, s, c, a, e in PACKAGES.values():
        t.configure(enabled=None, capacity=t.DEFAULT_CAPACITY)
        t.tracer().clear()
        m.registry().reset()
        s.reset_for_tests()
        c.reset_fault_points()
        a.reset_for_tests()
        e.reset_for_tests()
    for h in (jhealth, health):
        h.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for k in ("DL4J_TPU_CHAOS", "DL4J_TPU_TELEMETRY",
              "DL4J_TPU_FLIGHT_KEEP", "DL4J_TPU_SERVING_DEADLINE"):
        monkeypatch.delenv(k, raising=False)
    _reset_all()
    yield
    _reset_all()


# ===========================================================================
# metrics
# ===========================================================================


def _metric_ops(m):
    """One fixed sequence of operations on a fresh registry of package
    metrics module `m`; returns the registry."""
    reg = m.MetricsRegistry()
    c = reg.counter("req_total", "requests", ("outcome", "model"))
    c.labels("ok", "a").inc(3)
    c.labels(outcome="shed", model='q"uo\\te\nd').inc()
    c.labels("ok", "b").inc(0.25)
    reg.counter("plain_total").inc(2)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2.5)
    lg = reg.gauge("lanes", "per lane", ("lane",))
    lg.labels("x").set(-1e20)
    lg.labels("y").set(float("inf"))
    lg.labels("z").set(float("nan"))
    h = reg.histogram("lat_seconds", "latency",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.001, 0.05, 0.05, 0.5, 3.0):
        h.observe(v)
    hl = reg.histogram("rows", "rows", ("tenant",), buckets=(1, 4, 16))
    hl.labels("t1").observe(3)
    hl.labels("t2").merge_cumulative((1, 4, 16), (1, 2, 2), 7.5, 4)
    # re-registration returns the same family; a clash raises
    assert reg.counter("req_total", "requests", ("outcome", "model")) is c
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    return reg


def test_same_metric_operations_render_byte_identical_prometheus_text():
    want = _metric_ops(jmetrics)
    got = _metric_ops(metrics)
    assert got.render() == want.render()
    # NaN != NaN: compare the snapshots as JSON text
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    assert (got.get("rows").labels("t2").bucket_counts()
            == want.get("rows").labels("t2").bucket_counts())


def test_every_port_family_is_the_jax_family_letter_for_letter():
    """Each family the port registers at import (serving, tenancy,
    breaker, client, router, autoscaler, chaos, membership, flight, SLO,
    fleet, frames) exists in the JAX registry with the same type, help,
    labels and buckets."""
    port = {f.name: f for f in metrics.registry().families()}
    jax = {f.name: f for f in jmetrics.registry().families()}
    assert len(port) >= 30
    for name, f in port.items():
        j = jax.get(name)
        assert j is not None, name
        assert (f.typename, f.help, f.labelnames) == (
            j.typename, j.help, j.labelnames), name
        assert getattr(f, "_buckets", None) == getattr(j, "_buckets", None)
        assert f.render()[:2] == j.render()[:2], name  # HELP and TYPE


@pytest.mark.parametrize("fault", ["raise", "serving_dispatch@3:4",
                                   "serving_nan@3:4,serving_slow@1:2"])
def test_serving_metrics_tick_the_same_on_the_same_requests(monkeypatch,
                                                            fault):
    """The same request sequence through both packages' InferenceServer
    (an echo dispatch whose 3rd and 4th batches fail: raised by the
    dispatch or by the chaos points; a breaker that opens after two
    failures) ticks the same request, shed, row and breaker families,
    byte for byte, and gives the same typed outcomes."""
    if fault != "raise":
        monkeypatch.setenv("DL4J_TPU_CHAOS", fault)

    def run(rt, breaker_cls, bucket_cls, m, c):
        calls = [0]
        c.reset_fault_points()

        def dispatch(xp):
            calls[0] += 1
            if fault == "raise" and calls[0] in (3, 4):
                raise RuntimeError("injected")
            return np.asarray(xp, np.float32)

        s = rt.InferenceServer(
            dispatch=dispatch, batch_limit=4, queue_limit=8, wait_ms=0.0,
            buckets=bucket_cls(4, sizes=(1, 2, 4)), slow_fault_s=0.0,
            breaker=breaker_cls(failure_threshold=2, cooldown_s=1e3))
        outcomes = []
        try:
            for n in (1, 2, 3, 1, 2, 4):
                try:
                    s.output(np.ones((n, 3), np.float32), deadline_s=30.0)
                    outcomes.append("ok")
                except Exception as e:  # typed serving errors
                    outcomes.append(type(e).__name__)
        finally:
            s.shutdown()
        names = ("dl4j_tpu_serving_requests_total",
                 "dl4j_tpu_serving_shed_total", "dl4j_tpu_request_rows",
                 "dl4j_tpu_serving_breaker_transitions_total",
                 "dl4j_tpu_serving_queue_depth")
        text = live_text(m, names)
        count = m.registry().get("dl4j_tpu_serving_latency_seconds").count
        return outcomes, text, count

    want = run(jruntime, JBreaker, JBucketSpec, jmetrics, jchaos)
    got = run(runtime, CircuitBreaker, BucketSpec, metrics, chaos)
    assert got == want
    failed = ("NonFiniteOutputError" if "nan" in fault
              else "DispatchFailedError")
    assert got[0] == ["ok", "ok", failed, failed, "CircuitOpenError",
                      "CircuitOpenError"]


# ===========================================================================
# trace + context
# ===========================================================================


def _structure(events):
    """A Chrome trace with timestamps, pids, thread ids and random ids
    taken out: each event's name, category, phase and args, with span
    ids replaced by their order of first appearance (so nesting —
    parent_id pointing at a span_id — is compared, not the ids)."""
    ids = {}

    def idx(v):
        return ids.setdefault(v, f"#{len(ids)}")

    out = []
    for ev in events:
        args = dict(ev.get("args") or {})
        for k in ("trace_id", "span_id", "parent_id"):
            if k in args:
                args[k] = idx(args[k])
        if "member_traces" in args:
            args["member_traces"] = [idx(v) for v in args["member_traces"]]
        row = {k: ev[k] for k in ("name", "cat", "ph") if k in ev}
        if "id" in ev:
            row["id"] = idx(ev["id"])
        for k in ("s", "bp"):
            if k in ev:
                row[k] = ev[k]
        if ev.get("ph") == "M":
            row["args"] = args
        elif args:
            row["args"] = args
        out.append(row)
    return out


def _spans(t, ctx_mod):
    tr = t.Tracer(capacity=64, enabled=True)
    tr.set_thread_name(7, "lane seven")
    root = ctx_mod.new_trace()
    with ctx_mod.activate(root):
        with tr.span("outer", category="serving", rows=3) as sp:
            sp.set(bucket=4)
            with tr.span("inner"):
                tr.add_instant("mark", category="health", event="join")
            tr.add_span("measured", 2.5, category="etl", n=1)
            tr.add_flow("serving.batch", flow_id=root.trace_id, phase="s")
    tr.add_flow("serving.batch", flow_id=root.trace_id, phase="f")
    with tr.span("untraced"):
        pass
    tr.merge_training_stats({"events": [
        {"key": "fit", "start_time": 1.0, "duration_ms": 4.0, "worker": 2,
         "meta": {"trace_id": "abc", "span_id": "def", "shard": 1}},
        {"key": "split", "start_time": 0.5, "duration_ms": 9.0,
         "worker": None}]})
    return tr


def test_same_spans_give_the_same_chrome_trace_structure():
    want = _spans(jtrace, jcontext)
    got = _spans(trace, context)
    jw, pw = want.to_chrome_trace(), got.to_chrome_trace()
    assert _structure(pw["traceEvents"]) == _structure(jw["traceEvents"])
    assert pw["displayTimeUnit"] == jw["displayTimeUnit"]
    # the nesting itself: inner's parent is outer, the instant's is inner
    evs = {e["name"]: e for e in pw["traceEvents"] if e["ph"] != "M"}
    assert evs["inner"]["args"]["parent_id"] == evs["outer"]["args"][
        "span_id"]
    assert evs["mark"]["args"]["parent_id"] == evs["inner"]["args"][
        "span_id"]
    assert sorted(got.summary()) == sorted(want.summary())
    assert got.dropped == want.dropped == 0


def test_ring_cursor_gap_and_capacity_match():
    results = []
    for t in (jtrace, trace):
        tr = t.Tracer(capacity=4, enabled=True)
        for i in range(3):
            tr.add_instant(f"e{i}")
        first, cur, gap = tr.records_since(0)
        for i in range(3, 9):
            tr.add_instant(f"e{i}")
        later, cur2, gap2 = tr.records_since(cur)
        results.append(([r.name for r in first], cur, gap,
                        [r.name for r in later], cur2, gap2, tr.dropped,
                        len(tr)))
    assert results[0] == results[1]


def test_gate_off_allocates_no_span_and_the_gates_read_alike(monkeypatch):
    assert trace.tracer().span("x") is trace.NULL_SPAN
    with trace.tracer().span("x") as sp:
        sp.set(a=1)
    assert len(trace.tracer()) == 0
    assert slo.engine() is None and agg.collector() is None
    assert export.exporter() is None
    assert flight.dump("never") is None
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "on")
    assert trace.tracer().enabled and jtrace.tracer().enabled
    monkeypatch.setenv("DL4J_TPU_TELEMETRY_BUFFER", "5")
    trace.configure(capacity=3)
    assert trace.tracer().capacity == 3

    @trace.traced("work", category="c")
    def work():
        return 5

    assert work() == 5
    assert [r.name for r in trace.tracer().records()] == ["work"]


def test_serving_spans_match_jax_request_for_request(monkeypatch):
    """With the gate on, the same requests through both packages'
    InferenceServer leave the same span names, args and nesting per
    request trace (admission, flow, dispatch_batch, dispatch, resolve)."""

    def run(rt, t, bucket_cls):
        t.configure(enabled=True)
        t.tracer().clear()
        s = rt.InferenceServer(dispatch=lambda xp: np.asarray(xp) * 2.0,
                               batch_limit=4, wait_ms=0.0,
                               buckets=bucket_cls(4, sizes=(1, 2, 4)),
                               name="twin")
        try:
            for n in (1, 3, 2):
                s.output(np.ones((n, 2), np.float32), deadline_s=30.0)
        finally:
            s.shutdown()
        evs = t.tracer().to_chrome_trace()["traceEvents"]
        per_trace = {}
        for e in evs:
            tid = (e.get("args") or {}).get("trace_id")
            if tid is not None and e["name"] != "serving.dispatch_batch":
                per_trace.setdefault(tid, []).append(e)
        names = sorted(e["name"] for e in evs if e["ph"] != "M")
        lanes = sorted(e["args"]["name"] for e in evs if e["ph"] == "M")
        # the caller's flow start and the dispatcher's events race on
        # two threads: each trace's events are compared in a fixed order
        shapes = sorted(json.dumps(_structure(sorted(
            v, key=lambda e: (e["name"], e["ph"]))), sort_keys=True)
            for v in per_trace.values())
        batches = [e["args"] for e in evs
                   if e["name"] == "serving.dispatch_batch"]
        t.configure(enabled=None)
        return names, lanes, shapes, [
            (b["rows"], b["bucket"], len(b["member_traces"]))
            for b in batches]

    got = run(runtime, trace, BucketSpec)
    want = run(jruntime, jtrace, JBucketSpec)
    for g, w in zip(got, want):
        assert g == w


# ===========================================================================
# SLO engine
# ===========================================================================


def _slo_run(m, s):
    """Fixed counter operations and ticks on a fresh registry under the
    default, version and tenant rules; returns every tick's rows, the
    episode counts and the firing rules."""
    reg = m.MetricsRegistry()
    req = reg.counter("dl4j_tpu_serving_requests_total", "r", ("outcome",))
    shed = reg.counter("dl4j_tpu_serving_shed_total", "s", ("reason",))
    lat = reg.histogram("dl4j_tpu_serving_latency_seconds", "l",
                        buckets=(0.01, 0.1, 0.25, 1.0))
    mreq = reg.counter("dl4j_tpu_model_requests_total", "m",
                       ("model", "version", "outcome"))
    mlat = reg.histogram("dl4j_tpu_model_latency_seconds", "ml",
                         ("model", "version"), buckets=(0.01, 0.25, 1.0))
    windows = dict(fast_window_s=10.0, slow_window_s=30.0)
    rules = (s.default_rules() + s.version_rules("m", "v2", **windows)
             + s.tenant_rules("gold", **windows))
    eng = s.SloEngine(rules, registry=reg)
    rows = [eng.tick(now=0.0)]
    t = 0.0
    for step in range(12):
        t += 7.0
        bad = step in (3, 4, 5, 9)
        req.labels("ok").inc(50)
        req.labels("dispatch_error" if bad else "ok").inc(5)
        shed.labels("queue_full").inc(1 if bad else 0)
        for v in (0.005, 0.05, 0.3 if bad else 0.02):
            lat.observe(v)
        mreq.labels("m", "v2", "nonfinite" if bad else "ok").inc(3)
        mreq.labels("m", "v1", "ok").inc(10)
        mlat.labels("m", "v2").observe(0.5 if bad else 0.005)
        rows.append(eng.tick(now=t))
    eng.remove_rule("step_time")
    rows.append(eng.evaluate(now=t + 1.0))
    return rows, eng.episode_counts(), eng.firing(), s.render_status(
        rows[-1])


def test_slo_engine_gives_the_same_rows_and_episodes():
    want = _slo_run(jmetrics, jslo)
    got = _slo_run(metrics, slo)
    assert got == want
    rows, episodes, _, _ = got
    # the bad steps burn: at least one rule opened an episode, and one
    # rule opened two (the burn stopped and came back)
    assert max(episodes.values()) >= 2
    assert any(r["firing"] for tick in rows for r in tick)


def test_slo_episode_writes_one_bundle_with_offending_traces(monkeypatch,
                                                             tmp_path):
    """Gate on: a rising-edge episode writes exactly one slo_burn bundle
    (the offending trace ids scraped from the ring), in both packages;
    the module engine, status and healthz section agree."""
    results = []
    ctxs = {"jax": jcontext, "port": context}
    for name, (m, t, s, *_rest) in PACKAGES.items():
        d = tmp_path / name
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(d))
        t.configure(enabled=True)
        t.tracer().clear()
        m.registry().reset()
        req = m.counter("dl4j_tpu_serving_requests_total",
                        "Admitted requests resolved, by outcome",
                        ("outcome",))
        with ctxs[name].activate(ctxs[name].new_trace()):
            with t.tracer().span("serving.resolve",
                                 outcome="DispatchFailed"):
                pass
        eng = s.configure([s.SloRule(
            name="avail", objective=0.99,
            bad=(s.Selector("dl4j_tpu_serving_requests_total",
                            exclude={"outcome": ("ok",)}),),
            total=(s.Selector("dl4j_tpu_serving_requests_total"),),
            fast_window_s=5.0, slow_window_s=10.0)])
        s.tick(now=0.0)
        req.labels("ok").inc(10)
        req.labels("deadline").inc(10)
        rows = s.tick(now=6.0)
        s.tick(now=7.0)  # still firing: the same episode
        bundles = sorted(os.listdir(d))
        with open(d / bundles[0]) as f:
            doc = json.load(f)
        results.append((rows, len(bundles), doc["reason"], doc["note"],
                        sorted(doc["slo"]), len(doc["slo"][
                            "offending_traces"]), s.healthz_section(),
                        [r["slo"] for r in s.status()], eng is not None))
        t.configure(enabled=None)
    assert results[0] == results[1]
    assert results[1][1] == 1 and results[1][5] == 1


# ===========================================================================
# flight bundles cross both ways
# ===========================================================================


def _dump(m, t, fl, tmp, exc=None):
    t.configure(enabled=True)
    with t.tracer().span("serving.dispatch_batch", rows=4):
        pass
    m.counter("dl4j_tpu_flight_test_total", "t").inc(3)
    try:
        raise ValueError("boom")
    except ValueError as e:
        exc = e
    path = fl.dump("serving_breaker", exc=exc, note="non-finite output",
                   extra={"canary": {"model": "m"}, "reason": "ignored"})
    t.configure(enabled=None)
    return path


def test_each_package_reads_the_others_flight_bundle(monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    p_path = _dump(metrics, trace, flight, tmp_path)
    j_path = _dump(jmetrics, jtrace, jflight, tmp_path)
    assert p_path and j_path
    p_doc, j_doc = jflight.load_bundle(p_path), flight.load_bundle(j_path)
    assert sorted(p_doc) == sorted(j_doc)
    assert p_doc["bundle_version"] == j_doc["bundle_version"] == 1
    for doc in (p_doc, j_doc):
        assert doc["reason"] == "serving_breaker"  # extra never overrides
        assert doc["canary"] == {"model": "m"}
        assert doc["exception"]["type"] == "ValueError"
        assert doc["metrics"]["dl4j_tpu_flight_test_total"] == 3.0
    assert p_doc["runtime"]["process_count"] == 1
    assert p_doc["runtime"]["local_devices"]
    assert p_doc["analyzer_estimates"] is None
    assert p_doc["knobs"] == p_doc["env"]
    # no fit has beaten either package's monitor: both write the
    # no-heartbeat payload and an input verdict with no spans
    assert p_doc["health"] == j_doc["health"] == jhealth.healthz()
    assert p_doc["health"]["ok"] is False
    assert p_doc["input_pipeline"]["verdict"] == "unknown"
    assert sorted(p_doc["input_pipeline"]) == sorted(j_doc["input_pipeline"])
    # each summarize reads the other's bundle like its own: same lines,
    # the pid, time and phase table's durations aside
    for doc in (p_doc, j_doc):
        a, b = jflight.summarize(doc), flight.summarize(doc)
        assert a == b
        assert "reason=serving_breaker" in a
        assert "serving.dispatch_batch" in a
        assert "exception: ValueError: boom" in a
    assert sorted(flight.list_bundles(str(tmp_path))) == sorted(
        jflight.list_bundles(str(tmp_path)))


def test_bundle_rotation_and_faulthandler(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_KEEP", "2")
    trace.configure(enabled=True)
    paths = [flight.dump("r", note=str(i)) for i in range(4)]
    kept = flight.list_bundles()
    assert kept == sorted(paths[2:])
    assert metrics.registry().get("dl4j_tpu_flight_dumps_total").snapshot(
    )["reason=r"] == 4.0
    fh = flight.install_faulthandler()
    assert fh and os.path.isfile(fh)
    flight._reset_faulthandler_for_tests()
    assert flight.record_crash(RuntimeError("x"), phase="fit")


# ===========================================================================
# fleet collector
# ===========================================================================


def _frames(m, t, e, host, n, chaos_counter=None):
    reg = m.MetricsRegistry()
    tr = t.Tracer(capacity=64, enabled=True)
    exp = e.FrameExporter(host=host, replica="r0", registry=reg, tracer=tr)
    c = reg.counter("req_total", "requests", ("outcome",))
    g = reg.gauge("depth", "depth")
    h = reg.histogram("lat", "lat", buckets=(0.1, 1.0))
    out = []
    for i in range(n):
        c.labels("ok").inc(i + 1)
        g.set(10 - i)
        h.observe(0.05 * (i + 1))
        tr.add_instant("tick", i=i, outcome="ok" if i % 3 else "shed")
        out.append(exp.frame())
    return out


def _strip(frame, sent_at):
    """Frames of both packages with the wall-clock, pid, cursor, flight
    fields and the trace records' times made equal."""
    f = json.loads(json.dumps(frame))
    f["sent_at"] = sent_at
    f["source"]["pid"] = 1
    f["flight_index"], f["flight_dir"] = [], "d"
    f["knobs"] = {}
    for r in f["trace"]["records"]:
        r["start"], r["thread_id"] = 1.0, 1
    return f


def _collect(m, a, frames_by_host, order, chaos_spec, monkeypatch, c):
    monkeypatch.setenv("DL4J_TPU_CHAOS", chaos_spec)
    c.reset_fault_points()
    coll = a.FleetCollector()
    results = []
    for host, i in order:
        f = frames_by_host[host][i]
        results.append(coll.deliver(f, received_at=100.0 + i))
    outcomes = [coll.ingest(frames_by_host["b"][0], received_at=120.0)]
    coll.finalize()
    fam = ("dl4j_tpu_fleet_frames_total",
           "dl4j_tpu_fleet_frames_dropped_total",
           "dl4j_tpu_fleet_frames_duplicate_total",
           "dl4j_tpu_fleet_frames_late_total")
    # only this test's hosts: a reset keeps the series another test in
    # the same worker created, at 0
    counters = {n: own_series(m.registry().get(n).snapshot(),
                              host=("a", "b")) for n in fam}
    merged = coll.merged_chrome_trace()
    return (coll.render(), counters, outcomes,
            _structure(merged["traceEvents"]), merged["fleet"],
            coll.status(), coll._offending_traces())


def test_fleet_collector_merge_and_counters_match_under_drop_dup_reorder(
        monkeypatch):
    frames = {}
    for name, (m, t, s, c, a, e) in PACKAGES.items():
        frames[name] = {h: [_strip(f, 90.0 + k) for k, f in enumerate(
            _frames(m, t, e, h, 6))] for h in ("a", "b")}
    assert frames["jax"] == frames["port"]
    order = ([("a", i) for i in (0, 2, 1, 3, 5, 4)]
             + [("b", i) for i in (0, 1, 3, 4, 5)])
    got = {}
    for name, (m, t, s, c, a, e) in PACKAGES.items():
        got[name] = _collect(m, a, frames["jax"], order, "frame_drop@3:6:8",
                             monkeypatch, c)
    assert got["port"] == got["jax"]
    render, counters, outcomes, *_ = got["port"]
    assert outcomes == ["duplicate"]
    hosts = ("host=a,replica=r0", "host=b,replica=r0")
    assert counters["dl4j_tpu_fleet_frames_total"] == dict.fromkeys(
        hosts, 5.0)
    for n in ("dl4j_tpu_fleet_frames_dropped_total",
              "dl4j_tpu_fleet_frames_duplicate_total",
              "dl4j_tpu_fleet_frames_late_total"):
        assert counters[n] == dict.fromkeys(hosts, 1.0), n
    assert "req_total" in render and "depth_fleet" in render


def test_register_replica_and_local_host_pull_frames(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    assert agg.register_local_host()
    snaps = iter([{"queue_depth": 3, "ema_latency_s": 0.25}, None])
    assert agg.register_replica("r1", lambda: next(snaps), host="h")
    coll = agg.collector()
    assert coll.poll() == 2
    text = coll.render()
    assert ('dl4j_tpu_replica_queue_depth{host="h",replica="r1"} 3'
            in text)
    agg.deregister_replica("r1", host="h")
    status = {(s["host"], s["replica"]): s["live"]
              for s in coll.status()["sources"]}
    assert status[("h", "r1")] is False


def test_spool_directories_drain_in_both_directions(tmp_path):
    """Frames spooled by either package's exporter drain into the other
    package's collector with the same merge."""
    texts = []
    for name, (m, t, s, c, a, e) in PACKAGES.items():
        reg = m.MetricsRegistry()
        reg.counter("spooled_total", "s").inc(4)
        exp = e.FrameExporter(host=name, registry=reg,
                              tracer=t.Tracer(enabled=True))
        exp.spool(str(tmp_path / "spool"))
    for name, (m, t, s, c, a, e) in PACKAGES.items():
        coll = a.FleetCollector()
        coll.attach_spool(str(tmp_path / "spool"))
        assert coll.poll() == 2
        texts.append(coll.render())
    assert texts[0] == texts[1]
    assert 'spooled_total{host="jax",replica="-"} 4' in texts[0]
    assert 'spooled_total{host="port",replica="-"} 4' in texts[0]
