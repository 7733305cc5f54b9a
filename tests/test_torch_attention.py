"""The port's attention path against the JAX package: the flash-attention
forward (deeplearning4j_tpu_torch/ops/flash_attention.py) against the Pallas
kernel run as the JAX tests run it on the CPU (interpret mode), the plain
attention primitives (ops/attention.py), and the attention layers.

Inputs are made with numpy from a seed and handed to both packages; JAX
arrays are float32 (or bfloat16) even with x64 on. Tolerances, relative to
the largest magnitude of the expected output: float32 1e-5 (sums in another
order; the Pallas kernel's online softmax against the plain version's whole
row), bfloat16 2e-2 (P is rounded to bfloat16 at another running max in
each program), lse 1e-5 absolute.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.nn import inputs as jit_
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.nn import inputs as tit
from deeplearning4j_tpu_torch.nn.layers import attention as tlayers_att
from deeplearning4j_tpu_torch.nn.layers.base import Layer as TLayer
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import flash_attention as fa

DTYPES = {"float32": (np.float32, torch.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _qkv(shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(DTYPES[dtype][0])
            for _ in range(3)]


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _mask(b, t, seed=3, dead_row=None):
    m = (np.random.default_rng(seed).random((b, t)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if dead_row is not None:
        m[dead_row] = 0.0  # every key masked: uniform weights, not NaN
    return m


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(16, 16), (16, 64), (64, 16), (64, 64)])
def test_flash_matches_pallas_interpret(dtype, causal, t, d):
    q, k, v = _qkv((2, 3, t, d), dtype, seed=t + d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = pk.flash_attention(jq, jk, jv, causal, None, 16, 16, True)
    _, want_lse = pk._flash_fwd(jq, jk, jv, causal=causal, scale=d ** -0.5,
                                bq=16, bk=16, interpret=True, return_lse=True)
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        got, lse = fn(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal,
                      return_lse=True)
        assert got.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
        assert _rel(got, np.asarray(want, np.float32)) < DTYPES[dtype][2]
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_ragged_t_matches_sdpa(causal):
    """t = 13 is no multiple of any block: the JAX layer sends such lengths
    to sdpa, the port's kernel takes them."""
    q, k, v = _qkv((2, 3, 13, 16), seed=13)
    want = jatt.sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal)
    assert _rel(got, want) < 1e-5


def test_flash_scale_is_rounded_to_bfloat16_like_jax():
    """d = 32: d ** -0.5 is not a bfloat16 number; both programs round it
    to q's dtype before the multiply."""
    q, k, v = _qkv((1, 2, 16, 32), "bfloat16", seed=32)
    want = pk.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), True,
                              None, 16, 16, True)
    got = fa.flash_attention(_t(q, "bfloat16"), _t(k, "bfloat16"),
                             _t(v, "bfloat16"), True)
    assert _rel(got, np.asarray(want, np.float32)) < 2e-2
    assert fa.scale_in(torch.bfloat16, 32 ** -0.5) == float(
        jnp.asarray(32 ** -0.5, jnp.bfloat16))


def test_flash_launches_stay_zero_on_cpu():
    before = fa.flash_attention.launches
    fa.flash_attention(*(_t(a) for a in _qkv((1, 2, 8, 16))))
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["transposed", "shape", "dtype", "rank"])
def test_flash_refuses_what_it_does_not_take(bad):
    q, k, v = (_t(a) for a in _qkv((1, 2, 8, 16)))
    if bad == "transposed":
        # the [b, t, h, d] -> [b, h, t, d] head split, not copied
        q = _t(_qkv((1, 8, 2, 16))[0]).transpose(1, 2)
        assert not q.is_contiguous()
    elif bad == "shape":
        k = k[:, :, :4]
    elif bad == "dtype":
        v = v.double()
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


def test_flash_backward_matches_jax_grad():
    """The backward runs and gives jax.grad's gradients through the Pallas
    kernel in interpret mode. The full parity matrix is
    tests/test_torch_flash_bwd.py."""
    qkv = _qkv((1, 2, 16, 16))
    q, k, v = (_t(a).requires_grad_() for a in qkv)
    o = fa.flash_attention(q, k, v)
    assert o.requires_grad
    o.sum().backward()
    want = jax.grad(lambda *a: pk.flash_attention(*a, True, None, 16, 16,
                                                  True).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert _rel(got, w) < 1e-5


# ------------------------------------------------- attention primitives
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_sdpa_matches_jax(causal, masked):
    q, k, v = _qkv((3, 2, 9, 8), seed=9)
    m = _mask(3, 9, dead_row=2) if masked else None
    want = jatt.sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                     mask=None if m is None else jnp.asarray(m),
                     causal=causal)
    got = tatt.sdpa(_t(q), _t(k), _t(v),
                    mask=None if m is None else torch.from_numpy(m),
                    causal=causal)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("block", [4, 5, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax(block, causal):
    """Ragged key chunks (13 keys in blocks of 4 or 5), a key-padding mask
    with one row masked out entirely, and the one-block sdpa path."""
    q, k, v = _qkv((3, 2, 13, 8), seed=block)
    m = _mask(3, 13, dead_row=1)
    want = jatt.blockwise(*(jnp.asarray(a) for a in (q, k, v)),
                          mask=jnp.asarray(m), causal=causal,
                          block_size=block)
    got = tatt.blockwise(_t(q), _t(k), _t(v), mask=torch.from_numpy(m),
                         causal=causal, block_size=block)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) < 1e-5


def test_online_recurrence_with_offsets_matches_jax():
    """online_init / online_chunks / online_finish with global q and k
    offsets (a query block that starts later than the keys)."""
    q, _, _ = _qkv((2, 2, 6, 8), seed=1)
    _, k, v = _qkv((2, 2, 11, 8), seed=2)
    m = _mask(2, 11, seed=4)
    kw = dict(scale=0.3, causal=True, q_offset=5, k_offset=0, block_size=4)
    jacc = jatt.online_chunks(jatt.online_init(jnp.asarray(q)),
                              *(jnp.asarray(a) for a in (q, k, v)),
                              mask=jnp.asarray(m), **kw)
    tacc = tatt.online_chunks(tatt.online_init(_t(q)), _t(q), _t(k), _t(v),
                              mask=torch.from_numpy(m), **kw)
    for got, want in zip(tacc, jacc):
        assert _rel(got, want) < 1e-5
    assert _rel(tatt.online_finish(tacc), jatt.online_finish(jacc)) < 1e-5


def test_sdpa_under_mixed_precision_matches_jax():
    """bf16 operands under both mixed policies; scores and softmax stay
    float32 in both."""
    q, k, v = _qkv((2, 2, 9, 16), seed=5)
    with jdtypes.mixed(), tdtypes.mixed():
        want = jatt.sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
        got = tatt.sdpa(_t(q), _t(k), _t(v), causal=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got, want) < 2e-2


# --------------------------------------------------------------- layers
def _run_both(jlayer, in_type, x, mask=None, seed=0, tweak=None):
    """(jax output, port output) of one layer with the same weights."""
    jp = jlayer.init_params(jax.random.PRNGKey(seed), in_type)
    params = jax.tree_util.tree_map(np.asarray, jp)
    if tweak is not None:
        params = tweak(params, np.random.default_rng(seed))
    want, _ = jlayer.apply(jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(x), state={}, train=False, rng=None,
                           mask=None if mask is None else jnp.asarray(mask))
    tlayer = TLayer.from_json(json.loads(json.dumps(jlayer.to_json())))
    assert type(tlayer).__name__ == type(jlayer).__name__
    assert tlayer.to_json() == jlayer.to_json()
    tparams = interop.layer_params_from_jax(tlayer, params)
    xt = torch.from_numpy(np.asarray(x))
    got, _ = tlayer.apply(tparams, xt, state={}, train=False,
                          mask=None if mask is None else torch.from_numpy(mask))
    return np.asarray(want), got


def _btf(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _random_affine(params, rng):
    """Non-trivial gamma/beta and biases (ones and zeros would hide a
    swapped or dropped term)."""
    def walk(p):
        out = {}
        for key, val in p.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in ("gamma", "beta") or key.startswith("b"):
                out[key] = (rng.standard_normal(val.shape) * 0.3
                            + (1.0 if key == "gamma" else 0.0)
                            ).astype(np.float32)
            else:
                out[key] = val
        return out
    return walk(params)


def test_layernorm_matches_jax():
    want, got = _run_both(jlayers.LayerNorm(eps=1e-3), jit_.recurrent(12, 5),
                          _btf((2, 5, 12)) * 3 + 1, tweak=_random_affine)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("mode,f", [("learned", 8), ("sincos", 8),
                                    ("sincos", 7)])
def test_position_embedding_matches_jax(mode, f):
    layer = jlayers.PositionEmbedding(max_len=16, mode=mode)
    want, got = _run_both(layer, jit_.recurrent(f, 10), _btf((2, 10, f)))
    assert _rel(got, want) < 1e-6


def test_learned_position_embedding_refuses_over_length():
    layer = jlayers.PositionEmbedding(max_len=8)
    x = _btf((1, 9, 4))
    with pytest.raises(ValueError, match="max_len"):
        _run_both(layer, jit_.recurrent(4, 9), x)
    tlayer = TLayer.from_json(layer.to_json())
    params = {"pos": torch.zeros(8, 4)}
    with pytest.raises(ValueError, match="max_len"):
        tlayer.apply(params, torch.from_numpy(x), state={}, train=False)


@pytest.mark.parametrize("ids_dtype", [np.float32, np.int32])
@pytest.mark.parametrize("has_bias", [False, True])
def test_embedding_sequence_matches_jax(ids_dtype, has_bias):
    layer = jlayers.EmbeddingSequence(n_in=11, n_out=6, has_bias=has_bias)
    ids = np.random.default_rng(2).integers(0, 11, (3, 7)).astype(ids_dtype)
    want, got = _run_both(layer, jit_.recurrent(11, 7), ids,
                          tweak=_random_affine)
    assert got.dtype == torch.float32
    assert _rel(got, want) == 0


@pytest.mark.parametrize("layer", [
    jlayers.EmbeddingSequence(n_in=4, n_out=3),
    jlayers.Embedding(n_in=4, n_out=3, has_bias=False)])
def test_out_of_range_ids_give_nan_rows_like_jax(layer):
    """jnp.take's fill mode: ids in [-n, 0) count from the end, ids past
    either end give NaN rows (which the server refuses as non-finite)."""
    seq = isinstance(layer, jlayers.EmbeddingSequence)
    ids = np.array([0.0, 3.0, 4.0, -1.0, -5.0, 2.7], np.float32)
    ids = ids[None] if seq else ids
    want, got = _run_both(layer, jit_.recurrent(4, 6) if seq
                          else jit_.feed_forward(4), ids)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.nan_to_num(got.numpy()),
                                  np.nan_to_num(want))


@pytest.mark.parametrize("shape", [(5,), (5, 1)])
def test_embedding_matches_jax(shape):
    layer = jlayers.Embedding(n_in=9, n_out=4)
    ids = np.random.default_rng(3).integers(0, 9, shape).astype(np.float32)
    want, got = _run_both(layer, jit_.feed_forward(9), ids,
                          tweak=_random_affine)
    assert _rel(got, want) == 0


@pytest.mark.parametrize("impl,causal,masked", [
    ("auto", True, False), ("auto", False, False), ("auto", True, True),
    ("pallas", True, False), ("blockwise", True, True),
    ("blockwise", False, False)])
def test_multi_head_attention_matches_jax(impl, causal, masked):
    layer = jlayers.MultiHeadAttention(n_heads=4, causal=causal,
                                       attention_impl=impl, block_size=4)
    m = _mask(2, 10, dead_row=1) if masked else None
    want, got = _run_both(layer, jit_.recurrent(16, 10), _btf((2, 10, 16)),
                          mask=m, tweak=_random_affine)
    assert _rel(got, want) < 1e-5


def test_multi_head_attention_mixed_precision_matches_jax():
    layer = jlayers.MultiHeadAttention(n_heads=2, causal=True)
    with jdtypes.mixed(), tdtypes.mixed():
        want, got = _run_both(layer, jit_.recurrent(16, 12),
                              _btf((2, 12, 16)), tweak=_random_affine)
    assert got.dtype == torch.bfloat16
    assert _rel(got, np.asarray(want, np.float32)) < 2e-2


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_block_matches_jax(masked):
    layer = jlayers.TransformerBlock(n_heads=4, causal=True)
    m = _mask(2, 10) if masked else None
    want, got = _run_both(layer, jit_.recurrent(16, 10), _btf((2, 10, 16)),
                          mask=m, tweak=_random_affine)
    assert _rel(got, want) < 1e-5


def test_rnn_output_matches_jax():
    layer = jlayers.RnnOutput(n_out=7, loss="mcxent", activation="softmax")
    want, got = _run_both(layer, jit_.recurrent(5, 4), _btf((3, 4, 5)),
                          tweak=_random_affine)
    assert got.shape == (3, 4, 7)
    assert _rel(got, want) < 1e-6
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


# ------------------------------------------------------- kernel routing
@pytest.fixture
def flash_calls(monkeypatch):
    """Counts calls of the flash-attention entry point from the layer."""
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tlayers_att.fa, "flash_attention", spy)
    return calls


def _mha_call(impl, t, mask):
    """Two heads of dim 16, a head dim the kernel takes."""
    layer = tlayers_att.MultiHeadAttention(n_heads=2, causal=True,
                                           attention_impl=impl)
    gen = torch.Generator().manual_seed(0)
    params = layer.init_params(gen, tit.recurrent(32, t))
    x = torch.from_numpy(_btf((2, t, 32)))
    m = None if mask is None else torch.from_numpy(mask)
    y, _ = layer.apply(params, x, state={}, train=False, mask=m)
    return y


@pytest.mark.parametrize("t", [1, 13, 64])
def test_unmasked_attention_always_takes_the_flash_entry(flash_calls, t):
    """At every length, for a head dim in the kernel's set (other head
    dims take sdpa: tests/test_torch_routes.py)."""
    _mha_call("auto", t, None)
    _mha_call("pallas", t, None)
    assert flash_calls == [(2, 2, t, 16)] * 2


def test_masked_and_blockwise_attention_do_not_take_the_flash_entry(
        flash_calls):
    _mha_call("auto", 13, _mask(2, 13))
    _mha_call("blockwise", 13, None)
    _mha_call("sdpa", 13, None)
    assert flash_calls == []
