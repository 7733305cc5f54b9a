"""The port's ui/ package (deeplearning4j_tpu_torch/ui/: storage, stats,
components, flow, convolutional, server) against the JAX package's, over
the same state.

Each endpoint of both UIServers is fetched over the same storage contents
and the same telemetry: equal status codes, equal JSON keys (and equal
bodies where the state is the same), `/metrics` compared by `live_text`
over this test's families, `/healthz` merging the serving, models, fleet
and SLO sections with the same precedence. The routes that wait for later
slices answer 501 in the port (`/profile`, `/tune`) and `attach_embedding`
raises. StatsListener records of the same fit agree: the same keys and
iterations, scores within 1e-5 relative and each param's mean, stdev, min
and max within 1e-5 absolute (the port's fit tests' bounds; the updates
are deltas of those params, compared within 1e-6 absolute). Storage files
(JSONL and SQLite) written by either package are read by the other; the
flow graph and the activation grids are compared exactly (grid pixels
within one grey level, from float32 rounding at a channel's range).
"""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.serving import runtime as jruntime
from deeplearning4j_tpu.serving.breaker import CircuitBreaker as JBreaker
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.ui import components as jcomponents
from deeplearning4j_tpu.ui import convolutional as jconv
from deeplearning4j_tpu.ui import flow as jflow
from deeplearning4j_tpu.ui import storage as jstorage
from deeplearning4j_tpu_torch.serving import runtime
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.telemetry import metrics
from deeplearning4j_tpu_torch.telemetry import trace
from deeplearning4j_tpu_torch import ui
from deeplearning4j_tpu_torch.ui import components
from deeplearning4j_tpu_torch.ui import convolutional
from deeplearning4j_tpu_torch.ui import flow
from deeplearning4j_tpu_torch.ui import storage
from test_torch_fit_telemetry import iterators, nets
from test_torch_health import reset_all
from test_torch_telemetry import live_text

# (ui, storage, health, metrics, trace, runtime, breaker) per package
PACKAGES = {"jax": (jui, jstorage, jhealth, jmetrics, jtrace, jruntime,
                    JBreaker),
            "port": (ui, storage, health, metrics, trace, runtime,
                     CircuitBreaker)}
SESSION = "sess-A"


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("DL4J_TPU_TELEMETRY", "DL4J_TPU_CHAOS",
                "DL4J_TPU_STALL_TIMEOUT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_all()
    yield
    reset_all()


def stats_fit(epochs=1):
    """The tiny net fitted in both packages under a StatsListener of
    frequency 1; returns {package: InMemoryStatsStorage}."""
    jnet, pnet = nets()
    j, p = iterators()
    out = {}
    for name, net, it in (("jax", jnet, j), ("port", pnet, p)):
        u = PACKAGES[name][0]
        st = u.InMemoryStatsStorage()
        net.set_listeners(u.StatsListener(st, frequency=1,
                                          session_id=SESSION))
        net.fit(it, epochs=epochs)
        out[name] = st
    return out


@pytest.fixture(scope="module")
def reports():
    """One JAX fit's StatsListener reports (static first): the state both
    servers are given."""
    st = stats_fit()["jax"]
    return [st.get_static_info(SESSION)] + st.get_all_updates(SESSION)


@pytest.fixture
def servers(reports):
    out = {}
    for name, (u, *_r) in PACKAGES.items():
        s = u.UIServer(port=0)
        st = u.InMemoryStatsStorage()
        st.put_static_info(json.loads(json.dumps(reports[0])))
        for r in reports[1:]:
            st.put_update(json.loads(json.dumps(r)))
        s.attach(st)
        out[name] = s
    yield out
    for s in out.values():
        s.stop()


def get(server, path, data=None):
    """(status, content type, body as JSON or text)."""
    req = urllib.request.Request(server.url() + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    if ctype.startswith("application/json"):
        return code, ctype, json.loads(raw)
    return code, ctype, raw.decode()


SAME = ["/", "/train", "/train/overview", "/train/model", "/train/system",
        "/flow", "/tsne", "/activations", "/api/sessions",
        f"/api/updates?session={SESSION}", f"/api/updates?session={SESSION}"
        "&limit=2", f"/api/model?session={SESSION}",
        f"/api/system?session={SESSION}", f"/api/flow?session={SESSION}",
        "/api/tsne", f"/api/activations?session={SESSION}",
        "/api/updates?session=no-such", "/api/model?session=no-such",
        "/slo", "/fleet/metrics", "/fleet/trace", "/fleet/slo",
        "/fleet/status", "/healthz", "/no/such/route",
        "/trace?cursor=x"]


def _strip_volatile(path, body):
    """Fields that differ between two processes' runs: the backend's
    device names."""
    if path.startswith(("/api/model", "/api/system")) and body.get(
            "static"):
        body["static"].pop("devices")
    return body


@pytest.mark.parametrize("path", SAME)
def test_endpoint_answers_as_jax_over_the_same_state(servers, path):
    got = {name: get(s, path) for name, s in servers.items()}
    (jc, jt, jb), (pc, pt, pb) = got["jax"], got["port"]
    assert (pc, pt) == (jc, jt)
    if isinstance(pb, dict):
        assert _strip_volatile(path, pb) == _strip_volatile(path, jb)
    else:
        assert pb == jb


def test_metrics_and_trace_cursor_over_the_same_operations(servers):
    got = {}
    for name, s in servers.items():
        _, _, m, t, *_r = PACKAGES[name][1:]
        m.counter("dl4j_tpu_ui_test_total", "ui test", ("k",)).labels(
            "a").inc(3)
        tr = t.configure(enabled=True)
        tr.add_span("etl", 1.0, category="data")
        code, ctype, text = get(s, "/metrics")
        first = get(s, "/trace")
        tr.add_span("step", 2.0, category="train")
        delta = get(s, f"/trace?cursor={first[2]['cursor']}")
        t.configure(enabled=None)
        got[name] = (code, ctype, live_text(m, ("dl4j_tpu_ui_test_total",)),
                     "dl4j_tpu_ui_test_total" in text, first[0],
                     sorted(first[2]), delta[0], sorted(delta[2]),
                     [e["name"] for e in delta[2]["traceEvents"]],
                     delta[2]["gap"])
    assert got["port"] == got["jax"]
    assert got["port"][8] == ["step"]


@pytest.mark.parametrize("path", ["/profile", "/tune"])
def test_waiting_routes_answer_501_naming_their_item(servers, path):
    code, _, body = get(servers["port"], path)
    item = {"/profile": "A.11 item 3", "/tune": "A.11 item 4"}[path]
    assert code == 501 and item in body["error"]
    # the JAX server serves them; the port's refusal is explicit
    assert get(servers["jax"], path)[0] == 200


def test_attach_embedding_raises_and_tsne_lists_nothing(servers):
    with pytest.raises(NotImplementedError, match="A.11 item 6"):
        servers["port"].attach_embedding(np.zeros((4, 3)))
    assert get(servers["port"], "/api/tsne")[2] == {"embeddings": []}


def test_remote_post_as_jax(servers, reports):
    got = {}
    for name, s in servers.items():
        rows = [get(s, "/remote", json.dumps(r).encode())
                for r in (dict(reports[1], session_id="remote-1"),
                          {"no": "session"}, "not an object")]
        rows.append(get(s, "/remote", b"{not json"))
        rows.append(get(s, "/api/updates?session=remote-1"))
        got[name] = [(c, b) for c, _, b in rows]
    assert got["port"] == got["jax"]
    assert [c for c, _ in got["port"]] == [200, 400, 400, 400, 200]


def test_healthz_merges_training_serving_and_breaker_as_jax(
        servers, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    got = {}
    for name, s in servers.items():
        _, _, h, _, _, rt, br = PACKAGES[name]
        rows = [get(s, "/healthz")]
        srv = rt.InferenceServer(dispatch=lambda x: np.asarray(x) * 2,
                                 breaker=br(failure_threshold=1),
                                 batch_limit=2)
        try:
            rows.append(get(s, "/healthz"))
            srv.breaker.record_failure()
            rows.append(get(s, "/healthz"))
        finally:
            srv.shutdown()
        hb = h.fit_health("test.fit")
        hb.beat(5)
        rows.append(get(s, "/healthz"))
        hb.end()
        got[name] = [(c, b.get("ok"), b.get("reason"), sorted(b))
                     for c, _, b in rows]
    assert got["port"] == got["jax"]
    assert [r[:3] for r in got["port"][:3]] == [
        (503, False, "no heartbeat yet (no telemetry-enabled fit has "
                     "completed a step)"),
        (200, True, "serving runtime live (no training heartbeat)"),
        (503, False, "serving circuit breaker open")]
    assert got["port"][3][:2] == (200, True)


def test_stats_listener_records_match_jax():
    st = stats_fit(epochs=2)
    j_up = st["jax"].get_all_updates(SESSION)
    p_up = st["port"].get_all_updates(SESSION)
    assert [u["iteration"] for u in p_up] == [u["iteration"] for u in j_up]
    assert len(p_up) == 8
    for j, p in zip(j_up, p_up):
        assert sorted(p) == sorted(j)
        np.testing.assert_allclose(p["score"], j["score"], rtol=1e-5)
        assert sorted(p["params"]) == sorted(j["params"])
        for key in ("params", "updates"):
            for pname, js in j.get(key, {}).items():
                ps = p[key][pname]
                assert sorted(ps) == sorted(js)
                tol = 1e-5 if key == "params" else 1e-6
                for stat in ("mean", "stdev", "min", "max"):
                    np.testing.assert_allclose(ps[stat], js[stat], rtol=0,
                                               atol=tol)
                assert sum(ps["histogram"]["counts"]) == sum(
                    js["histogram"]["counts"])
        assert sorted(p.get("timing", {})) == sorted(j.get("timing", {}))
    j_info = st["jax"].get_static_info(SESSION)
    p_info = st["port"].get_static_info(SESSION)
    assert sorted(p_info) == sorted(j_info)
    for key in ("model_class", "num_params", "num_layers", "graph",
                "backend"):
        assert p_info[key] == j_info[key], key


@pytest.mark.parametrize("kind", ["file", "sqlite"])
def test_storage_files_cross_packages(tmp_path, reports, kind):
    cls = {"file": "FileStatsStorage", "sqlite": "SqliteStatsStorage"}[kind]
    for writer, reader in ((storage, jstorage), (jstorage, storage)):
        path = str(tmp_path / f"{writer.__name__}.{kind}")
        w = getattr(writer, cls)(path)
        w.put_static_info(reports[0])
        for r in reports[1:]:
            w.put_update(r)
        r_ = getattr(reader, cls)(path)
        assert r_.list_session_ids() == [SESSION]
        assert r_.get_static_info(SESSION) == w.get_static_info(SESSION)
        assert r_.get_all_updates(SESSION) == w.get_all_updates(SESSION)


def test_flow_graph_and_page_as_jax(tmp_path):
    jnet, pnet = nets()
    assert flow.build_graph(pnet) == jflow.build_graph(jnet)
    a = flow.write_model_graph_html(pnet, str(tmp_path / "p.html"))
    b = jflow.write_model_graph_html(jnet, str(tmp_path / "j.html"))
    assert open(a).read() == open(b).read()


def test_components_serialize_and_render_as_jax():
    def make(mod):
        chart = mod.ChartLine(title="score").add_series(
            "s", [0, 1, 2], [1.0, 0.5, 0.25])
        hist = mod.ChartHistogram(title="h").add_bin(-1.0, 0.0, 1).add_bin(
            0.0, 1.0, 3)
        return mod.ComponentDiv(children=[
            chart, hist, mod.ComponentText(text="<b>x</b>"),
            mod.ComponentTable(header=["a"], rows=[["1"]])])

    p, j = make(components), make(jcomponents)
    assert p.to_json() == j.to_json()
    assert p.render_html() == j.render_html()
    assert components.Component.from_json(j.to_json()).to_json() == \
        j.to_json()


def test_convolutional_listener_grids_as_jax(tmp_path):
    from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import inputs as jit
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.layers import Conv2D as JConv2D
    from deeplearning4j_tpu.nn.layers import Output as JOutput
    from deeplearning4j_tpu_torch import interop
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    conf = JNNC(seed=3).list([
        JConv2D(kernel_size=(3, 3), n_out=5, activation="relu"),
        JOutput(n_out=2, loss="mcxent"),
    ]).set_input_type(jit.convolutional(8, 8, 2))
    jnet = JMLN(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    interop.params_from_jax(pnet, jax.tree_util.tree_map(
        np.asarray, jnet.params), jax.tree_util.tree_map(
        np.asarray, jnet.state))
    probe = np.random.default_rng(5).standard_normal(
        (2, 8, 8, 2)).astype(np.float32)
    got = {}
    for name, mod, net in (("jax", jconv, jnet), ("port", convolutional,
                                                   pnet)):
        st = PACKAGES[name][0].InMemoryStatsStorage()
        lst = mod.ConvolutionalIterationListener(
            probe, frequency=1, router=st, session_id=SESSION)
        lst.iteration_done(net, 1, 0.0)
        got[name] = (lst.last_grids, st.get_all_updates(SESSION))
    (jg, ju), (pg, pu) = got["jax"], got["port"]
    assert len(pg) == len(jg) == 2  # the input and the Conv2D
    for a, b in zip(pg, jg):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert [{k: v for k, v in u.items() if k != "image"} for u in pu] == [
        {k: v for k, v in u.items() if k != "image"} for u in ju]
    assert convolutional.tile_activations(probe[0]).tolist() == \
        jconv.tile_activations(probe[0]).tolist()


def _stub_factory():
    """Replica stand-ins for an Autoscaler (the router tests' shape)."""

    class Stub:
        def __init__(self, name):
            self.name, self.stopped, self.crashed = name, False, False

        def snapshot(self):
            return {"name": self.name, "queue_depth": 0,
                    "queue_depth_p50": None, "ema_latency_s": None}

        def output(self, x, deadline_s=None, tenant=None):
            return np.asarray([self.name])

        def shutdown(self, timeout=5.0):
            self.stopped = True

    return lambda name, tenancy: Stub(name)


def test_models_and_fleet_scrapes_tick_the_control_loops(servers):
    """Scraping /models evaluates the live routers and /fleet the live
    autoscalers, as in JAX: the same ramp from scrapes alone, the same
    payload keys, and /healthz carrying both sections."""
    import gc

    from deeplearning4j_tpu.serving import autoscaler as jautoscaler
    from deeplearning4j_tpu.serving import registry as jregistry
    from deeplearning4j_tpu.serving import router as jrouter
    from deeplearning4j_tpu_torch.serving import autoscaler, registry, router

    mods = {"jax": (jregistry, jrouter, jautoscaler),
            "port": (registry, router, autoscaler)}
    gc.collect()  # routers and pools of earlier tests are weakly held
    got = {}
    for name, s in servers.items():
        reg_mod, rt_mod, as_mod = mods[name]
        rows = [get(s, "/fleet")[0]]
        reg = reg_mod.ModelRegistry()
        for version, k, stable in (("v1", 1.0, True), ("v2", 2.0, False)):
            reg.register("m", dispatch=lambda x, k=k: np.asarray(x) * k,
                         version=version, stable=stable, batch_limit=4)
        rt = rt_mod.Router(reg)
        rt.start_rollout("m", "v2", stages=(0.5, 1.0), min_requests=1,
                         fast_window_s=60.0, slow_window_s=600.0,
                         latency_threshold_s=10.0)
        pool = as_mod.Autoscaler(_stub_factory(), min_replicas=1,
                                 max_replicas=2, clock=lambda: 0.0)
        try:
            for _ in range(3):
                answers = [float(np.asarray(rt.output(
                    "m", np.ones((1, 2), np.float32), deadline_s=30.0))[0, 0])
                    for _ in range(4)]
                code, _, body = get(s, "/models")
                rows.append((code, sorted(body), answers, [
                    (r["state"], r["history"]) for r in body["rollouts"]]))
            code, _, body = get(s, "/fleet")
            rows.append((code, sorted(body), sorted(body["pools"][0]),
                         body["replicas"]))
            code, _, body = get(s, "/healthz")
            rows.append((code, "models" in body, "fleet" in body))
        finally:
            pool.shutdown()
            reg.shutdown()
        got[name] = rows
    assert got["port"] == got["jax"]
    ramps = [r[3] for r in got["port"][1:4]]
    assert ramps[-1] == [("promoted", ["50", "100", "promote"])]
    assert got["port"][4][0] == 200 and got["port"][4][3] == 1
    # the registry's servers are live: "serving runtime live"
    assert got["port"][5] == (200, True, True)
