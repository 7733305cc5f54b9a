"""The port's ParallelInference (deeplearning4j_tpu_torch/parallel/
inference.py) against the JAX package's on zoo LeNet, and its liveness
rules (tests/test_serving.py's TestParallelInferenceFixed and
TestServingGate, ported).

The same seeded numpy requests go through both packages' ParallelInference
from the same weights (the JAX network's, carried over by interop), in
BATCHED and INSTANT mode, with the DL4J_TPU_SERVING gate off and on: on
one device (the JAX mesh of one virtual device) and on a grid of two
gloo ranks (the JAX mesh of two, data=2), where rank 0 dispatches and
rank 1 follows (tests/torch_dp_worker.py "pi" case). Answers agree within
1e-5 absolute (softmax rows of float32 convolutions summed in another
order on each side). Every wait in these tests is bounded.
"""
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelInference as JPI
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import (
    DeadlineExceededError,
    DispatcherCrashedError,
    InferenceServer,
    ServingError,
    ShutdownError,
)
from test_torch_parallel import WORKER, jax_net, port_net, save_weights

TOL = 1e-5
SIZES = (1, 3, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lenets():
    conf = JLeNet().conf().to_json()
    jnet = jax_net("mln", conf)
    return conf, jnet, port_net("mln", conf, jnet)


def _requests(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
            for n in SIZES]


def _serve(pi, xs):
    """Every request at once from its own thread; then shutdown."""
    try:
        with cf.ThreadPoolExecutor(len(xs)) as pool:
            return list(pool.map(lambda x: np.asarray(
                pi.output(x, deadline_s=60.0)), xs))
    finally:
        pi.shutdown()


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("mode", ["batched", "instant"])
def test_answers_match_jax_on_lenet(lenets, monkeypatch, mode, gate):
    """One device: the port's answers against the JAX ParallelInference's
    on a one-device mesh and against net.output, request by request."""
    _, jnet, tnet = lenets
    if gate:
        monkeypatch.setenv("DL4J_TPU_SERVING", "1")
    else:
        monkeypatch.delenv("DL4J_TPU_SERVING", raising=False)
    xs = _requests()
    pi = ParallelInference(tnet, mode=mode, batch_limit=8)
    assert (pi._serving is not None) == gate
    got = _serve(pi, xs)
    mesh = jbuild_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    want = _serve(JPI(jnet, mesh=mesh, mode=mode, batch_limit=8), xs)
    for x, g, w in zip(xs, got, want):
        assert g.shape == w.shape == (x.shape[0], 10)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
        np.testing.assert_allclose(g, tnet.output(x).numpy(), rtol=0,
                                   atol=TOL)


def test_grid_of_two_gloo_ranks_matches_jax_at_data_2(lenets, tmp_path):
    """MeshSpec(data=2) over two gloo ranks: rank 0 dispatches each padded
    batch, both ranks run their half, rank 1 follows until the stop
    message. BATCHED and INSTANT with the gate off and BATCHED with it on,
    one process group; rank 0's answers against the JAX ParallelInference
    on two virtual devices and against net.output."""
    conf, jnet, tnet = lenets
    xs = _requests(seed=4)
    data = str(tmp_path / "requests.npz")
    np.savez(data, **{f"x{i}": x for i, x in enumerate(xs)})
    base = dict(pi=True, kind="mln", conf=conf,
                weights=save_weights(tmp_path, jnet), data=data,
                batch_limit=8, mesh={"data": 2})
    cases = {"batched": dict(base, mode="batched"),
             "instant": dict(base, mode="instant"),
             "serving": dict(base, mode="batched", serving=True)}
    procs = []
    for r in range(2):
        spec = {"rank": r, "world": 2, "init": f"file://{tmp_path}/rdv",
                "threads": 1,
                "cases": [dict(c, out=str(tmp_path / f"{n}_rank{r}.npz"))
                          for n, c in cases.items()]}
        path = tmp_path / f"spec{r}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(path)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    mesh = jbuild_mesh(JMeshSpec(data=2), devices=jax.devices()[:2])
    want = {mode: _serve(JPI(jnet, mesh=mesh, mode=mode, batch_limit=8), xs)
            for mode in ("batched", "instant")}
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    for name, case in cases.items():
        got = np.load(tmp_path / f"{name}_rank0.npz")
        served = int(np.load(tmp_path / f"{name}_rank1.npz")["served"])
        # one batch per request in INSTANT mode; at most that in BATCHED
        assert 1 <= served <= len(xs)
        for i, x in enumerate(xs):
            np.testing.assert_allclose(got[f"out{i}"], want[case["mode"]][i],
                                       rtol=0, atol=TOL)
            np.testing.assert_allclose(got[f"out{i}"],
                                       tnet.output(x).numpy(), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("how", ["gate_off", "gate_on", "server"])
def test_grid_shutdown_stops_the_followers_after_the_batch_in_flight(
        lenets, tmp_path, how):
    """Rank 0 shuts down with a 0.1 s timeout while a batch whose forward
    sleeps 1 s is in flight over two gloo ranks: through ParallelInference
    with the DL4J_TPU_SERVING gate off and on, and through an
    InferenceServer on the grid used directly. The stop message goes out
    only after that batch: the request gets its answer (within 1e-5 of
    net.output), the follower served that one batch and returned, and
    both ranks exit."""
    conf, jnet, tnet = lenets
    x = _requests(seed=5)[1]
    data = str(tmp_path / "requests.npz")
    np.savez(data, x0=x)
    case = dict(pi=True, kind="mln", conf=conf,
                weights=save_weights(tmp_path, jnet), data=data,
                batch_limit=8, mesh={"data": 2}, mode="batched",
                serving=how == "gate_on", direct=how == "server",
                slow=1.0, shutdown_timeout=0.1)
    procs = []
    for r in range(2):
        spec = dict(case, rank=r, world=2, init=f"file://{tmp_path}/rdv",
                    threads=1, out=str(tmp_path / f"rank{r}.npz"))
        path = tmp_path / f"spec{r}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(path)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    got = np.load(tmp_path / "rank0.npz")
    assert int(np.load(tmp_path / "rank1.npz")["served"]) == 1
    # the shutdown waited for the batch (its forward's 1 s sleep began
    # before the shutdown did)
    assert float(got["shutdown_s"]) > 0.1
    np.testing.assert_allclose(got["out0"], tnet.output(x).numpy(), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------- liveness
class _FakeModel:
    """model.output contract only — what both dispatchers need."""

    def __init__(self, fn=None, delay=0.0):
        self.fn = fn or (lambda x: np.asarray(x) * 2.0)
        self.delay = delay

    def output(self, x):
        if self.delay:
            time.sleep(self.delay)
        return self.fn(np.asarray(x))


def _pi(model=None, **kw):
    kw.setdefault("batch_limit", 8)
    return ParallelInference(model or _FakeModel(), **kw)


def test_shutdown_drains_queued_callers():
    pi = _pi(_FakeModel(delay=0.1), batch_limit=1, wait_ms=0.0)
    results = []

    def call():
        try:
            pi.output(np.zeros((1, 2), np.float32))
            results.append("ok")
        except ServingError as e:
            results.append(type(e).__name__)

    threads = [threading.Thread(target=call, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    pi.shutdown()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)  # nobody parked
    assert len(results) == 4
    assert set(results) <= {"ok", "ShutdownError"}
    assert "ShutdownError" in results
    with pytest.raises(ShutdownError):
        pi.output(np.zeros((1, 2), np.float32))


def test_oversize_request_not_silently_merged():
    seen = []
    pi = _pi(_FakeModel(fn=lambda x: seen.append(x.shape[0]) or x * 2.0),
             batch_limit=4)
    try:
        x = np.arange(36, dtype=np.float32).reshape(12, 3)
        np.testing.assert_array_equal(pi.output(x), x * 2.0)
        assert 12 in seen  # dispatched alone, past the limit but whole
    finally:
        pi.shutdown()


def test_coalescing_never_overshoots_limit():
    seen = []
    pi = _pi(_FakeModel(fn=lambda x: seen.append(x.shape[0])
                        or (time.sleep(0.01), x * 2.0)[1]),
             batch_limit=4, wait_ms=20.0)
    try:
        xs = [np.full((3, 2), i, np.float32) for i in range(6)]
        with cf.ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(pi.output, xs))
        for o, x in zip(outs, xs):
            np.testing.assert_array_equal(o, x * 2.0)
        # 3-row requests against limit 4: one per batch, never 3 + 3
        assert max(seen) <= 4
    finally:
        pi.shutdown()


def test_mismatched_shape_fails_alone():
    def picky(x):
        if x.shape[1] != 4:
            raise ValueError("bad trailing shape")
        return x * 2.0

    pi = _pi(_FakeModel(fn=picky), wait_ms=10.0)
    try:
        good = np.zeros((2, 4), np.float32)
        bad = np.zeros((2, 5), np.float32)
        with cf.ThreadPoolExecutor(3) as ex:
            f1 = ex.submit(pi.output, good)
            f2 = ex.submit(pi.output, bad)
            f3 = ex.submit(pi.output, good)
            np.testing.assert_array_equal(f1.result(10), good * 2.0)
            np.testing.assert_array_equal(f3.result(10), good * 2.0)
            with pytest.raises(ValueError):
                f2.result(10)
    finally:
        pi.shutdown()


def test_dead_dispatcher_surfaces_not_queues_forever():
    pi = _pi()

    def bomb(batch):
        raise SystemExit("dispatcher bug")

    pi._run_batch = bomb
    with pytest.raises(DispatcherCrashedError):
        pi.output(np.zeros((1, 2), np.float32))
    with pytest.raises(DispatcherCrashedError):
        pi.output(np.zeros((1, 2), np.float32))
    pi.shutdown()


def test_output_deadline_bounds_the_wait():
    pi = _pi(_FakeModel(delay=0.3), batch_limit=1, wait_ms=0.0)
    try:
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceededError):
            pi.output(np.zeros((1, 2), np.float32), deadline_s=0.05)
        assert time.perf_counter() - t0 < 0.25
    finally:
        pi.shutdown()


def test_gate_off_imports_no_serving_runtime():
    """The gate-off dispatcher allocates no serving state: in a fresh
    process, serving a request leaves serving/runtime.py unimported and
    starts no InferenceServer thread."""
    code = (
        "import sys, threading, numpy as np\n"
        "from deeplearning4j_tpu_torch.parallel import ParallelInference\n"
        "class M:\n"
        "    def output(self, x):\n"
        "        return np.asarray(x) * 2.0\n"
        "pi = ParallelInference(M())\n"
        "out = pi.output(np.ones((2, 3), np.float32))\n"
        "assert pi._serving is None and pi._thread.is_alive()\n"
        "names = [t.name for t in threading.enumerate()]\n"
        "pi.shutdown()\n"
        "print(float(out.sum()),\n"
        "      'deeplearning4j_tpu_torch.serving.runtime' in sys.modules,\n"
        "      any(n.startswith('InferenceServer') for n in names),\n"
        "      pi._thread.is_alive())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DL4J_TPU_SERVING", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["12.0", "False", "False", "False"]


def test_gate_on_routes_through_serving_runtime(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SERVING", "1")
    pi = ParallelInference(_FakeModel(), batch_limit=8)
    try:
        assert isinstance(pi._serving, InferenceServer)
        out = pi.output(np.ones((2, 3), np.float32), deadline_s=5.0)
        np.testing.assert_array_equal(out, np.full((2, 3), 2.0))
    finally:
        pi.shutdown()
    assert pi._serving.stopped


def test_without_a_mesh_it_serves_one_device():
    """`workers` is the JAX signature's device count: without a grid
    only one device serves, and rank-0-only calls refuse elsewhere."""
    with pytest.raises(ValueError, match="build_mesh"):
        ParallelInference(_FakeModel(), workers=2)
    pi = ParallelInference(_FakeModel(), workers=1)
    try:
        with pytest.raises(RuntimeError, match="other ranks"):
            pi.follow()
    finally:
        pi.shutdown()
