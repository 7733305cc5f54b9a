"""The port's threshold gradient compression (parallel/compression.py)
against the JAX package's on the same numpy-seeded gradients: the
counterparts of tests/test_parallel.py's
test_threshold_compression_roundtrip and
test_encoding_handler_residual_accumulates, then handlers of both
packages run side by side over several rounds (messages, deltas,
residuals and the adaptive threshold) in the fixed-capacity and the
exact-density codecs. Indices and thresholds compare exactly, values and
residuals to float32 rounding (1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import compression as jcomp
from deeplearning4j_tpu_torch.parallel import compression as comp


def test_threshold_compression_roundtrip():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(100).astype(np.float32)
    idx, vals, residual = comp.threshold_encode(torch.from_numpy(g), 0.5, 50)
    delta = comp.threshold_decode(idx, vals, 100)
    np.testing.assert_allclose((delta + residual).numpy(), g, atol=1e-6)
    sent = vals.numpy()[idx.numpy() >= 0]
    assert set(np.round(np.abs(sent), 5)) <= {0.5}
    jidx, jvals, jres = jcomp.threshold_encode(jnp.asarray(g), 0.5, 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-6)
    np.testing.assert_allclose(residual.numpy(), np.asarray(jres),
                               atol=1e-6)


def test_encoding_handler_residual_accumulates():
    """Below the threshold nothing is sent and the residual keeps it; the
    second round's residual crosses it. Ties (every entry 0.3) go to the
    lower indices, as lax.top_k takes them."""
    h = comp.EncodingHandler(threshold=0.5, capacity_fraction=0.5)
    jh = jcomp.EncodingHandler(threshold=0.5, capacity_fraction=0.5)
    grads = {"W": np.full((10,), 0.3, np.float32)}
    _, delta = h.encode_tree(grads)
    assert torch.all(delta["W"] == 0)
    jh.encode_tree(grads)
    _, delta = h.encode_tree(grads)
    _, jdelta = jh.encode_tree(grads)
    assert delta["W"].max() > 0
    np.testing.assert_allclose(delta["W"].numpy(), np.asarray(jdelta["W"]),
                               atol=1e-7)
    assert h.threshold == pytest.approx(jh.threshold, rel=1e-12)


@pytest.mark.parametrize("host_codec", [False, True])
def test_handlers_agree_over_rounds(host_codec):
    """Five rounds of a two-layer gradient tree through both handlers."""
    rng = np.random.default_rng(4)
    h = comp.EncodingHandler(threshold=0.05, capacity_fraction=0.1,
                             target_density=0.05,
                             use_host_codec=host_codec)
    jh = jcomp.EncodingHandler(threshold=0.05, capacity_fraction=0.1,
                               target_density=0.05,
                               use_host_codec=host_codec)
    for _ in range(5):
        grads = {"layer_0": {"W": rng.standard_normal((6, 5)).astype(
            np.float32) * 0.1, "b": rng.standard_normal(5).astype(
            np.float32) * 0.1},
                 "layer_1": {"W": rng.standard_normal((5, 3)).astype(
                     np.float32) * 0.1}}
        msgs, deltas = h.encode_tree({k: {n: torch.from_numpy(v)
                                          for n, v in t.items()}
                                      for k, t in grads.items()})
        jmsgs, jdeltas = jh.encode_tree(grads)
        assert sorted(msgs) == sorted(jmsgs)
        for key, (idx, vals, size) in msgs.items():
            jidx, jvals, jsize = jmsgs[key]
            assert size == jsize
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_allclose(vals.numpy(), np.asarray(jvals),
                                       atol=1e-6)
            np.testing.assert_allclose(h._residuals[key].numpy(),
                                       np.asarray(jh._residuals[key]),
                                       atol=1e-6)
        for k in grads:
            for n in grads[k]:
                np.testing.assert_allclose(deltas[k][n].numpy(),
                                           np.asarray(jdeltas[k][n]),
                                           atol=1e-6)
        assert h.threshold == pytest.approx(jh.threshold, rel=1e-12)
        decoded = comp.EncodingHandler.decode_messages(msgs, deltas)
        for k in grads:
            for n in grads[k]:
                torch.testing.assert_close(decoded[k][n], deltas[k][n])
