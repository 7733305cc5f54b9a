"""The training call sites' telemetry in the port (training/engine.py,
parallel/wrapper.py, resilience/checkpoint.py, retry.py, sentry.py)
against the JAX package's, on the same numpy-seeded data and the same
weights (the JAX network's, carried over by interop).

The networks are a Dense + Output net and, for a plain fit, the zoo
LeNet on 12 x 12 x 1 images. Compared exactly, with `DL4J_TPU_TELEMETRY`
on: the spans' names,
categories and counts (the etl and step spans of a fit, "collective"
steps under ParallelWrapper, the checkpoint.write / checkpoint.restore
spans), that every span of a fit carries the fit's one trace id, the
`dl4j_tpu_step_seconds` count, the checkpoint, retry, sentry and chaos
counters, the chaos points firing at the same call index (the iteration
a fault leaves the network at), and crash, sentry and stall bundles whose
keys either package's `load_bundle` reads. Scores agree within 1e-5
relative (the port's fit tests' bound); durations are never compared.
The port's wrapper runs at world size 1 over gloo, the JAX wrapper on one
virtual device. Registries, tracers, monitors and fault counters of both
packages are reset around every test.
"""
import collections
import os

import jax
import numpy as np
import pytest
import torch.distributed as dist

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import updaters as jupdaters
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import Output as JOutput
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu import resilience as jres
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.telemetry import flight as jflight
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import resilience as tres
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelWrapper,
    init_process_group,
)
from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import trace
from test_torch_health import reset_all
from test_torch_telemetry import own_series

RTOL = 1e-5
ROWS, BATCH = 24, 6


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("DL4J_TPU_TELEMETRY", "DL4J_TPU_CHAOS",
                "DL4J_TPU_STALL_TIMEOUT", "DL4J_TPU_STEP_WINDOW",
                "DL4J_TPU_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_TPU_RETRY_BACKOFF", "0")
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    reset_all()
    yield
    reset_all()


def data(kind="dense"):
    rng = np.random.default_rng(11)
    if kind == "lenet":
        x = rng.standard_normal((ROWS, 12, 12, 1)).astype(np.float32)
        return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, ROWS)]
    x = rng.standard_normal((ROWS, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, ROWS)]
    return x, y


def nets(kind="dense"):
    """(JAX network, port network with its weights): a Dense + Output
    net on 4 features, or the zoo LeNet on 12 x 12 x 1 images."""
    if kind == "lenet":
        conf = jzoo.LeNet(input_shape=(12, 12, 1)).conf()
    else:
        conf = JNNC(seed=1, updater=jupdaters.Adam(
            learning_rate=5e-3)).list([
                JDense(n_out=16, activation="relu"),
                JOutput(n_out=3, loss="mcxent"),
            ]).set_input_type(jit.feed_forward(4))
    jnet = JMLN(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    interop.params_from_jax(pnet, jax.tree_util.tree_map(
        np.asarray, jnet.params), jax.tree_util.tree_map(
        np.asarray, jnet.state))
    return jnet, pnet


def iterators(wrap=None, kind="dense"):
    x, y = data(kind)
    j = JListIterator(jds.DataSet(x, y), batch=BATCH)
    p = ListDataSetIterator(DataSet(x, y), batch=BATCH)
    if wrap is not None:
        j = jres.ChaosDataSetIterator(j, **wrap)
        p = tres.ChaosDataSetIterator(p, **wrap)
    return j, p


def fit_both(epochs=1, kind="dense", **attachments):
    """The tiny net's `fit` in both packages; returns (jnet, pnet)."""
    jnet, pnet = nets(kind)
    j, p = iterators(kind=kind)
    jnet.fit(j, epochs=epochs, **attachments.get("jax", {}))
    pnet.fit(p, epochs=epochs, **attachments.get("port", {}))
    return jnet, pnet


def spans(t):
    """Counter of (name, category) over the complete spans, and the trace
    ids the fit's etl / step / collective spans carry. The JAX compile
    watcher's "compile" spans (telemetry/introspect.py, ROADMAP A.11 item
    3; an eager torch step compiles nothing) are left out."""
    recs = [r for r in t.tracer().records()
            if r.phase == "X" and r.category != "compile"]
    names = collections.Counter((r.name, r.category) for r in recs)
    ids = {r.trace_id for r in recs if r.name in ("etl", "step")}
    return names, ids


def step_count(m):
    return m.registry().get("dl4j_tpu_step_seconds").snapshot()["count"]


@pytest.mark.parametrize("kind", ["dense", "lenet"])
def test_fit_spans_histogram_and_etl_time_match_jax(kind):
    jnet, pnet = fit_both(kind=kind)
    got = {name: (spans(t), step_count(m)) for name, t, m in (
        ("jax", jtrace, jmetrics), ("port", trace, metrics))}
    (j_names, j_ids), j_count = got["jax"]
    (p_names, p_ids), p_count = got["port"]
    assert p_names == j_names
    assert p_names[("etl", "data")] == p_names[("step", "train")] == 4
    assert p_count == j_count == 4
    # one fit, one trace id on every etl and step span
    assert len(p_ids) == len(j_ids) == 1 and None not in p_ids
    assert pnet.last_etl_time_ms >= 0.0 and jnet.last_etl_time_ms >= 0.0
    np.testing.assert_allclose(pnet.score_, jnet.score_, rtol=RTOL)


@pytest.fixture
def group(tmp_path):
    init_process_group(f"file://{tmp_path}/rdv", 0, 1, device="cpu")
    yield
    dist.destroy_process_group()


def wrapper_fit_both(epochs=1, wrap=None, flight_root=None):
    """Both packages' ParallelWrapper over one rank (each package's flight
    bundles under `flight_root`/jax and /port when given); returns the two
    networks and the two exceptions (None where the fit ended)."""
    jnet, pnet = nets()
    j, p = iterators(wrap)
    out = []
    for name, fit in (("jax", lambda: JWrapper(jnet, mesh=jbuild_mesh(
            JMeshSpec(data=1), devices=jax.devices()[:1])).fit(
            j, epochs=epochs)),
            ("port", lambda: ParallelWrapper(
                pnet, mesh_spec=MeshSpec(data=1)).fit(p, epochs=epochs))):
        if flight_root is not None:
            os.environ["DL4J_TPU_FLIGHT_DIR"] = str(flight_root / name)
        try:
            fit()
            out.append(None)
        except Exception as e:  # the chaos faults under test
            out.append(e)
    return jnet, pnet, out


@pytest.mark.parametrize("window", [1, 2])
def test_wrapper_steps_are_collective_spans(group, monkeypatch, window):
    monkeypatch.setenv("DL4J_TPU_STEP_WINDOW", str(window))
    jnet, pnet, errors = wrapper_fit_both()
    assert errors == [None, None]
    j_names, j_ids = spans(jtrace)
    p_names, p_ids = spans(trace)
    # the JAX wrapper also draws one lane per mesh device
    # (introspect.emit_device_step_lanes), which waits for the port's
    # introspection; the main lane's spans agree
    lanes = j_names.pop(("device.step", "collective"))
    assert lanes == 4 // window  # one per dispatch
    assert p_names == j_names
    assert p_names[("step", "collective")] == 4
    assert step_count(metrics) == step_count(jmetrics) == 4
    assert len(p_ids) == 1
    np.testing.assert_allclose(pnet.score_, jnet.score_, rtol=RTOL)


@pytest.mark.parametrize("window,spec,iteration", [
    (1, "collective@3", 2), (2, "collective@2", 2)])
def test_collective_fault_at_the_same_call_leaves_a_crash_bundle(
        group, monkeypatch, tmp_path, window, spec, iteration):
    monkeypatch.setenv("DL4J_TPU_STEP_WINDOW", str(window))
    monkeypatch.setenv("DL4J_TPU_CHAOS", spec)
    jnet, pnet, errors = wrapper_fit_both(flight_root=tmp_path / "flight")
    assert [type(e).__name__ for e in errors] == ["ChaosError"] * 2
    assert pnet.iteration == jnet.iteration == iteration
    docs = {}
    for name, f, t in (("jax", jflight, jtrace), ("port", flight, trace)):
        paths = f.list_bundles(str(tmp_path / "flight" / name))
        assert len(paths) == 1 and "exception" in paths[0], name
        docs[name] = (f.load_bundle(paths[0]), spans(t)[1])
    p_doc, j_doc = (jflight.load_bundle(flight.list_bundles(
        str(tmp_path / "flight" / "port"))[0]), flight.load_bundle(
        jflight.list_bundles(str(tmp_path / "flight" / "jax"))[0]))
    assert sorted(p_doc) == sorted(j_doc)
    for name, (doc, ids) in docs.items():
        assert doc["reason"] == "exception"
        assert doc["note"] == "ParallelWrapper.fit"
        assert doc["exception"]["type"] == "ChaosError"
        # the crash bundle stamps the fit's trace id
        assert ids == {doc["trace_id"]}, name
        assert doc["metrics"]["dl4j_tpu_chaos_injections_total"][
            "point=collective"] == 1.0


FAMILIES = {
    "dl4j_tpu_retry_attempts_total": {"error": "ChaosError"},
    "dl4j_tpu_sentry_trips_total": {"policy": "rollback"},
    "dl4j_tpu_chaos_injections_total": {
        "point": ("checkpoint_write", "iterator_nan")},
}
UNLABELLED = ("dl4j_tpu_retry_exhausted_total",
              "dl4j_tpu_sentry_rollbacks_total",
              "dl4j_tpu_checkpoint_restore_fallbacks_total")
HISTOGRAMS = ("dl4j_tpu_checkpoint_write_seconds",
              "dl4j_tpu_checkpoint_restore_seconds")


def counters(m):
    reg = m.registry()
    out = {n: own_series(reg.get(n).snapshot(), **labels)
           for n, labels in FAMILIES.items()}
    out.update({n: reg.get(n).snapshot() for n in UNLABELLED})
    out.update({n: reg.get(n).snapshot()["count"] for n in HISTOGRAMS})
    out["bytes_written"] = reg.get(
        "dl4j_tpu_checkpoint_write_bytes_total").snapshot() > 0
    return out


def test_checkpointed_retried_sentry_guarded_fit_counts_as_jax(
        monkeypatch, tmp_path):
    """Two epochs under a CheckpointManager whose first payload write
    fails once (the retry lands it), with a NaN batch in epoch two that
    the rollback sentry catches: the same counters, spans and bundles."""
    monkeypatch.setenv("DL4J_TPU_CHAOS", "checkpoint_write@1")
    got = {}
    for name, pkg, m, t, f in (("jax", jres, jmetrics, jtrace, jflight),
                               ("port", tres, metrics, trace, flight)):
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / name))
        pkg.reset_fault_points()
        jnet, pnet = nets()
        net = jnet if name == "jax" else pnet
        cm = pkg.CheckpointManager(str(tmp_path / name))
        net.add_listeners(pkg.DivergenceSentry(checkpoint_manager=cm,
                                               policy="rollback"))
        it = iterators(dict(nan_at=(6,)))[0 if name == "jax" else 1]
        net.fit(it, epochs=2, checkpoint_manager=cm)
        names = spans(t)[0]
        got[name] = (counters(m),
                     {k: v for k, v in names.items()
                      if k[1] == "checkpoint"},
                     sorted(os.path.basename(p).split("_", 4)[4]
                            for p in f.list_bundles()),
                     net.iteration, net.epoch, cm.list_steps())
    assert got["port"] == got["jax"]
    c = got["port"][0]
    assert c["dl4j_tpu_retry_attempts_total"] == {"error=ChaosError": 1.0}
    assert c["dl4j_tpu_sentry_trips_total"] == {"policy=rollback": 1.0}
    assert c["dl4j_tpu_sentry_rollbacks_total"] == 1.0
    assert c["dl4j_tpu_checkpoint_write_seconds"] == 2
    assert got["port"][2] == ["sentry.json"]
    p_path = flight.list_bundles(str(tmp_path / "port"))[0]
    j_path = jflight.list_bundles(str(tmp_path / "jax"))[0]
    assert sorted(jflight.load_bundle(p_path)) == sorted(
        flight.load_bundle(j_path))


def test_a_failing_fit_writes_one_crash_bundle_with_its_phase(
        monkeypatch, tmp_path):
    got = {}
    for name, f in (("jax", jflight), ("port", flight)):
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / name))
        jnet, pnet = nets()
        net = jnet if name == "jax" else pnet
        it = iterators(dict(fail_at=(2,)))[0 if name == "jax" else 1]
        with pytest.raises(Exception) as info:
            net.fit(it, epochs=1)
        paths = f.list_bundles()
        assert len(paths) == 1
        doc = f.load_bundle(paths[0])
        got[name] = (type(info.value).__name__, doc["reason"], doc["note"],
                     doc["exception"]["type"], net.iteration,
                     doc["health"]["phase"])
    assert got["port"] == got["jax"] == (
        "ChaosError", "exception", "MultiLayerNetwork.fit", "ChaosError", 1,
        "MultiLayerNetwork.fit")


def test_autotune_gate_raises_until_the_tuner_is_ported(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_AUTOTUNE", "1")
    _, pnet = nets()
    with pytest.raises(NotImplementedError, match="A.11 item 4"):
        pnet.fit(iterators()[1])
    assert pnet.iteration == 0
