"""The port's HealthMonitor (deeplearning4j_tpu_torch/telemetry/health.py)
and the prefetch iterator's accounting against the JAX package's on the
same inputs.

Compared exactly: the stall watchdog's counter series, healthz keys and
bundle keys (each package's `load_bundle` reads the other's stall bundle);
straggler reports, gauges and the once-per-lane warning; the per-worker
grouping of `ingest_event_stats`; `input_verdict` over the same etl/step
spans (input-bound, balanced, compute-bound, unknown); the prefetch
queue's sample count and producer lane with the gate on, and nothing
allocated with it off. Timings (step ages, wait seconds) are never
compared. Both packages' registries, tracers and monitors are reset
around every test, and series are compared by this test's own labels.
"""
import time
import types
import warnings

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jiterators
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.telemetry import flight as jflight
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.datasets import iterators as titerators
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import trace
from test_torch_telemetry import labelled_text, own_series

# (health, metrics, trace, flight, chaos, dataset, iterators) per package
PACKAGES = {"jax": (jhealth, jmetrics, jtrace, jflight, jchaos, jds,
                    jiterators),
            "port": (health, metrics, trace, flight, chaos, tds,
                     titerators)}
GATES = ("DL4J_TPU_TELEMETRY", "DL4J_TPU_CHAOS", "DL4J_TPU_STALL_TIMEOUT",
         "DL4J_TPU_STRAGGLER_RATIO")


def reset_all():
    for h, m, t, f, c, *_ in PACKAGES.values():
        t.configure(enabled=None)
        t.tracer().clear()
        m.registry().reset()
        c.reset_fault_points()
        h.reset_for_tests()
        f._reset_faulthandler_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in GATES:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_all()
    yield
    reset_all()


def _stalls(m):
    return own_series(m.registry().get(
        "dl4j_tpu_stall_detected_total").snapshot(), phase="test.fit")


def test_stall_fires_once_with_a_bundle_each_package_reads(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    monkeypatch.setenv("DL4J_TPU_STALL_TIMEOUT", "0.15")
    got = {}
    for name, (h, m, t, f, *_rest) in PACKAGES.items():
        hb = h.fit_health("test.fit")
        hb.beat(3)
        deadline = time.perf_counter() + 10.0
        while not _stalls(m) and time.perf_counter() < deadline:
            time.sleep(0.02)
        snap = h.healthz()
        # one episode, one report: no second firing while still stalled
        time.sleep(0.4)
        stalls = _stalls(m)
        path = snap["last_stall_bundle"]
        hb.beat(4)
        after = h.healthz()
        hb.end()
        got[name] = (stalls, snap, path, after)
    for name, (stalls, snap, path, after) in got.items():
        assert stalls == {"phase=test.fit": 1.0}, name
        assert snap["ok"] is False and snap["stalled"] is True
        assert (snap["phase"], snap["iteration"], snap["stalls"]) == (
            "test.fit", 3, 1)
        assert after["ok"] is True and after["iteration"] == 4
        assert "stall" in path
    assert sorted(got["port"][1]) == sorted(got["jax"][1])
    # each package reads the other's stall bundle
    p_doc = jflight.load_bundle(got["port"][2])
    j_doc = flight.load_bundle(got["jax"][2])
    assert sorted(p_doc) == sorted(j_doc)
    for doc in (p_doc, j_doc):
        assert doc["reason"] == "stall"
        assert doc["health"]["stalls"] == 1
        assert any(e.get("name") == "stall" and e.get("ph") == "i"
                   for e in doc["trace"]["traceEvents"])


def test_healthz_is_503_payload_before_a_beat_and_keys_match_after(
        monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    before = {name: h.healthz() for name, (h, *_r) in PACKAGES.items()}
    assert before["port"] == before["jax"]
    assert before["port"]["ok"] is False
    after = {}
    for name, (h, *_r) in PACKAGES.items():
        hb = h.fit_health("test.fit")
        hb.beat(7)
        after[name] = h.healthz()
        hb.end()
    assert sorted(after["port"]) == sorted(after["jax"])
    assert sorted(after["port"]["input_pipeline"]) == sorted(
        after["jax"]["input_pipeline"])
    for key in ("ok", "phase", "iteration", "active_fits", "stalled",
                "stalls", "stall_timeout_s", "stragglers",
                "last_stall_bundle"):
        assert after["port"][key] == after["jax"][key], key


def test_skew_gauges_and_the_warning_once_per_lane(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    lanes = {"w0": 1.0, "w1": 1.1, "w2": 5.0}
    got = {}
    for name, (h, m, t, *_r) in PACKAGES.items():
        mon = h.monitor()
        with pytest.warns(UserWarning, match="straggler detected: w2"):
            report = mon.observe_worker_skew(lanes)
        with warnings.catch_warnings():
            # the second sighting of a straggler stays silent
            warnings.simplefilter("error")
            again = mon.observe_worker_skew(lanes)
        instants = [r.attrs for r in t.tracer().records()
                    if r.name == "straggler"]
        got[name] = (report, again, instants, labelled_text(
            m, ("dl4j_tpu_straggler_skew_ratio",),
            device=tuple(lanes)), mon.snapshot()["stragglers"])
    assert got["port"] == got["jax"]
    report = got["port"][0]
    assert report["w2"] > 2.0 and report["w0"] <= 1.0
    assert len(got["port"][2]) == 2  # an instant per straggling window


def test_ingest_event_stats_groups_by_worker(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    monkeypatch.setenv("DL4J_TPU_STRAGGLER_RATIO", "3.0")
    events = [
        {"worker": 0, "duration_ms": 100.0},
        types.SimpleNamespace(worker=1, duration_ms=110.0),
        {"worker": 0, "duration_ms": 120.0},  # summed per worker
        {"worker": None, "duration_ms": 999.0},  # the master: skipped
        types.SimpleNamespace(worker=2, duration_ms=None),  # no duration
    ]
    got = {name: (h.monitor().ingest_event_stats(events),
                  h.monitor().ingest_event_stats(events[:2]))
           for name, (h, *_r) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    report, _ = got["port"]
    assert set(report) == {"worker 0", "worker 1"}
    assert report["worker 0"] > report["worker 1"]
    # one worker is no skew
    one = {name: h.monitor().ingest_event_stats(events[:1])
           for name, (h, *_r) in PACKAGES.items()}
    assert one["port"] == one["jax"] == {}


@pytest.mark.parametrize("etl,step,verdict", [
    ([10, 12, 11], [2, 2, 3], "input_bound"),
    ([4, 4], [10, 10], "balanced"),
    ([0.1, 0.1], [10, 10], "compute_bound"),
    ([], [], "unknown"),
])
def test_input_verdict_over_the_same_spans(monkeypatch, etl, step, verdict):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    got = {}
    for name, (h, m, t, *_r) in PACKAGES.items():
        tr = t.configure(enabled=True)
        for e in etl:
            tr.add_span("etl", e, category="data")
        for s in step:
            tr.add_span("step", s, category="train")
        got[name] = h.input_verdict()
        # scoped to a window of records, as bench rows scope it
        got[name + "_scoped"] = h.input_verdict(records=tr.records()[:1])
    assert got["port"] == got["jax"]
    assert got["port_scoped"] == got["jax_scoped"]
    assert got["port"]["verdict"] == verdict


def _batches(ds_mod, n=5, rows=6):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n * rows, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n * rows)]
    return ds_mod.DataSet(x, y)


def test_prefetch_accounting_on_and_the_gate_off_allocates_nothing(
        monkeypatch):
    # gate off: no monitor is created, whatever the iterator does
    for name, (h, m, t, f, c, ds_mod, it_mod) in PACKAGES.items():
        monkeypatch.setattr(h, "_monitor", None)
        a = it_mod.AsyncDataSetIterator(
            it_mod.ListDataSetIterator(_batches(ds_mod), batch=6),
            queue_size=2)
        assert sum(1 for _ in a) == 5
        assert h._monitor is None and h.live() is None
        assert h.fit_health("x") is h.NULL_HEALTH
        assert h._monitor is None, name
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    got = {}
    for name, (h, m, t, f, c, ds_mod, it_mod) in PACKAGES.items():
        a = it_mod.AsyncDataSetIterator(
            it_mod.ListDataSetIterator(_batches(ds_mod), batch=6),
            queue_size=2)
        assert sum(1 for _ in a) == 5
        mon = h.monitor()
        lanes = [e["args"]["name"] for e in
                 t.tracer().to_chrome_trace()["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"]
        v = h.input_verdict()
        got[name] = (len(mon.depths), sorted(v),
                     [n.split("-prefetch-")[0] for n in lanes])
        assert v["consumer_wait_seconds"] >= 0.0
        assert v["queue_depth_p50"] is not None
        a.shutdown()
    assert got["port"] == got["jax"]
    # one sample per fetch, the end-of-stream fetch included
    assert got["port"][0] == 6
    assert got["port"][2] == ["AsyncDataSetIterator"]


def test_fit_beats_the_monitor_and_ends_the_fit(monkeypatch):
    """A port fit heartbeats once per step and closes its fit; the last
    phase and iteration are the fit's, as the JAX fit leaves them."""
    from test_torch_fit_telemetry import fit_both

    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    monkeypatch.setenv("DL4J_TPU_STALL_TIMEOUT", "30")
    fit_both()
    got = {name: h.healthz() for name, (h, *_r) in PACKAGES.items()}
    for snap in got.values():
        assert snap["ok"] is True and snap["active_fits"] == 0
    assert (got["port"]["phase"], got["port"]["iteration"]) == (
        got["jax"]["phase"], got["jax"]["iteration"]) == (
        "MultiLayerNetwork.fit", 4)
