"""The port's InferenceServer (deeplearning4j_tpu_torch/serving): requests
answered through a port network on the CPU equal `net.output`; every
failure mode is a typed, bounded outcome; the bucket and breaker copies
behave as the JAX package's.

Every wait in these tests is bounded (server calls carry deadlines or the
dispatcher is released by an event with a timeout).
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import breaker as jbreaker
from deeplearning4j_tpu.serving import buckets as jbuckets
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    GlobalPooling,
    Output,
)
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.serving import breaker as tbreaker
from deeplearning4j_tpu_torch.serving import buckets as tbuckets
from deeplearning4j_tpu_torch.serving import (
    CircuitOpenError,
    DeadlineExceededError,
    DispatchFailedError,
    InferenceServer,
    NonFiniteOutputError,
    ShedError,
    ShutdownError,
)


@pytest.fixture(scope="module")
def net():
    conf = (NeuralNetConfiguration(seed=3).graph().add_inputs("in")
            .add_layer("c", Conv2D(kernel_size=(3, 3), stride=(2, 2), n_out=8,
                                   convolution_mode="same", has_bias=False),
                       "in")
            .add_layer("bn", BatchNorm(activation="relu"), "c")
            .add_layer("pool", GlobalPooling(pooling_type="avg"), "bn")
            .add_layer("out", Output(n_out=5), "pool")
            .set_outputs("out")
            .set_input_types(it.convolutional(9, 9, 3)))
    return ComputationGraph(conf).init(device="cpu")


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 9, 9, 3)).astype(np.float32)


def test_server_answers_requests_like_net_output(net):
    server = InferenceServer(model=net, batch_limit=8)
    try:
        server.warmup(_x(1, 0))
        assert server.warmed_rows == {(((9, 9, 3), "float32"), b)
                                      for b in (1, 2, 4, 8)}
        xs = [_x(n, n) for n in (1, 3, 8)]
        reqs = [server.submit(x, deadline_s=30) for x in xs]
        outs = [server.result(r) for r in reqs]
    finally:
        server.shutdown()
    for x, out in zip(xs, outs):
        assert isinstance(out, np.ndarray) and out.shape == (len(x), 5)
        np.testing.assert_allclose(out, net.output(x).numpy(), rtol=1e-5,
                                   atol=1e-7)
    snap = server.snapshot()
    assert snap["breaker"]["state"] == "closed" and snap["stopping"]


def test_warmup_dispatches_every_bucket_on_the_dispatcher_thread():
    """cuDNN/cuBLAS handles are per thread: the warm-up batches must run
    where traffic will."""
    seen = []

    def dispatch(xb):
        seen.append((threading.current_thread().name, len(xb)))
        return torch.zeros(len(xb), 2)

    server = InferenceServer(dispatch=dispatch, batch_limit=8,
                             warmup_example=np.ones((3, 4), np.float32))
    try:
        assert [n for _, n in seen] == [1, 2, 4, 8]
        assert all(t == server._thread.name for t, _ in seen)
        assert server.warmed_rows == {(((4,), "float32"), b)
                                      for b in (1, 2, 4, 8)}
        snap = server.snapshot()  # warm-up is not traffic
        assert snap["ema_latency_s"] is None and snap["latency_p50_s"] is None
    finally:
        server.shutdown()


class _Gate:
    """A dispatch callable that blocks until released (bounded wait)."""

    def __init__(self, result=None, exc=None):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.result, self.exc = result, exc

    def __call__(self, xb):
        self.entered.set()
        assert self.release.wait(10)
        if self.exc is not None:
            raise self.exc
        if self.result is not None:
            return self.result(xb)
        return torch.from_numpy(xb.reshape(len(xb), -1)[:, :2].copy())


def test_dispatch_exception_is_a_typed_error():
    gate = _Gate(exc=RuntimeError("device wedged"))
    gate.release.set()
    server = InferenceServer(dispatch=gate, batch_limit=4)
    try:
        with pytest.raises(DispatchFailedError) as ei:
            server.output(np.ones((2, 3), np.float32), deadline_s=10)
        assert isinstance(ei.value.cause, RuntimeError)
    finally:
        server.shutdown()


def test_non_finite_output_is_rejected_and_counts_against_breaker():
    gate = _Gate(result=lambda xb: torch.full((len(xb), 2), float("nan")))
    gate.release.set()
    server = InferenceServer(
        dispatch=gate, batch_limit=4,
        breaker=tbreaker.CircuitBreaker(failure_threshold=1, cooldown_s=60))
    try:
        with pytest.raises(NonFiniteOutputError):
            server.output(np.ones((1, 3), np.float32), deadline_s=10)
        with pytest.raises(CircuitOpenError) as ei:
            server.submit(np.ones((1, 3), np.float32))
        assert ei.value.retry_after_s > 0
    finally:
        server.shutdown()


def test_full_queue_sheds_newest():
    gate = _Gate()
    server = InferenceServer(dispatch=gate, batch_limit=1, queue_limit=1,
                             wait_ms=0)
    try:
        first = server.submit(np.ones((1, 3), np.float32))
        assert gate.entered.wait(10)  # first is in flight
        queued = server.submit(np.ones((1, 3), np.float32))
        with pytest.raises(ShedError):
            server.submit(np.ones((1, 3), np.float32))
        gate.release.set()
        assert server.result(first).shape == (1, 2)
        assert server.result(queued).shape == (1, 2)
    finally:
        gate.release.set()
        server.shutdown()


def test_drop_oldest_resolves_the_oldest_with_shed_error():
    gate = _Gate()
    server = InferenceServer(dispatch=gate, batch_limit=1, queue_limit=1,
                             wait_ms=0, shed_policy="drop_oldest")
    try:
        server.submit(np.ones((1, 3), np.float32))
        assert gate.entered.wait(10)
        oldest = server.submit(np.ones((1, 3), np.float32))
        newest = server.submit(np.ones((1, 3), np.float32))
        with pytest.raises(ShedError):
            server.result(oldest)
        gate.release.set()
        assert server.result(newest).shape == (1, 2)
    finally:
        gate.release.set()
        server.shutdown()


def test_deadline_expires_in_queue():
    gate = _Gate()
    server = InferenceServer(dispatch=gate, batch_limit=1, wait_ms=0)
    try:
        server.submit(np.ones((1, 3), np.float32))
        assert gate.entered.wait(10)
        late = server.submit(np.ones((1, 3), np.float32), deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            server.result(late)
    finally:
        gate.release.set()
        server.shutdown()


def test_shutdown_drains_queued_requests_and_refuses_new_ones():
    gate = _Gate()
    server = InferenceServer(dispatch=gate, batch_limit=1, wait_ms=0)
    inflight = server.submit(np.ones((1, 3), np.float32))
    assert gate.entered.wait(10)
    queued = [server.submit(np.ones((1, 3), np.float32)) for _ in range(3)]
    done = threading.Thread(target=server.shutdown, kwargs={"timeout": 10})
    done.start()
    gate.release.set()
    done.join(15)
    assert not done.is_alive()
    assert server.result(inflight).shape == (1, 2)  # in-flight completes
    for r in queued:
        with pytest.raises(ShutdownError):
            server.result(r)
    with pytest.raises(ShutdownError):
        server.submit(np.ones((1, 3), np.float32))
    assert server.stopped


@pytest.mark.parametrize("max_batch,align,sizes", [
    (32, 1, None), (33, 1, None), (1, 1, None), (48, 4, None),
    (32, 1, (3, 7, 32)), (64, 8, (1, 9, 17)),
])
def test_bucket_spec_matches_jax(max_batch, align, sizes):
    j = jbuckets.BucketSpec(max_batch, align=align, sizes=sizes)
    t = tbuckets.BucketSpec(max_batch, align=align, sizes=sizes)
    assert t.sizes == j.sizes
    for n in range(1, 2 * max_batch + 2):
        assert t.bucket_for(n) == j.bucket_for(n)
        assert t.padded_size(n) == j.padded_size(n)


def test_pad_rows_and_signature_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tbuckets.pad_rows(x, 8),
                                  jbuckets.pad_rows(x, 8))
    assert tbuckets.signature(x) == jbuckets.signature(x)
    with pytest.raises(ValueError):
        tbuckets.pad_rows(x, 2)


def test_breaker_arc_matches_jax():
    """The same event sequence drives both breakers through closed -> open
    -> half_open -> closed under a fake clock, state for state."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    kw = dict(failure_threshold=2, cooldown_s=1.0, probe_successes=2,
              clock=clock)
    j, t = jbreaker.CircuitBreaker(**kw), tbreaker.CircuitBreaker(**kw)
    events = ["fail", "fail", "admit", "tick", "admit", "admit", "success",
              "admit", "success", "admit", "fail", "fail", "tick", "admit",
              "fail", "admit"]
    for ev in events:
        for b in (j, t):
            if ev == "fail":
                b.record_failure("x")
            elif ev == "success":
                b.record_success()
            elif ev == "tick":
                pass
        if ev == "tick":
            now[0] += 1.5
        if ev == "admit":
            assert t.admit() == j.admit()
        assert t.state == j.state, ev
        assert t.retry_after_s() == j.retry_after_s()
