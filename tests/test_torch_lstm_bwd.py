"""The recurrent-training kernels of the port against the JAX package: the
plain versions of the fused LSTM backward (row 6), the time-chunked forward
(row 7) and the chunked backward (row 8) in deeplearning4j_tpu_torch/ops/
lstm.py against the Pallas kernels run as the JAX tests run them on the CPU
(interpret mode); autograd through the port's scans against `jax.vjp`; the
two kernel families against each other; the routing predicate; and the
wrappers' contract (no launch on the CPU, refusals).

Inputs are made with numpy from a seed and handed to both packages, at
b = 12 (the JAX backward takes its kernel from b = 8: a block of 8 rows and
a ragged second one) with nonzero h0, c0, g_hT and g_cT. Tolerances,
relative to the largest magnitude of each expected output (1 where it is
smaller): 1e-5 for every float32 output, in both dtypes (sums in another
order, sigmoid/tanh from another library; both packages compute in float32
from the same bfloat16 inputs; measured worst 5.8e-7); bfloat16 outputs
(hs, hT, cT, dzx) 4e-3, one bfloat16 ulp at the largest magnitude: a
float32 value that differs in its last bits may round the other way
(measured worst 1.2e-4).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.ops import lstm as tlstm

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": {"dzx": 1e-5, "f32": 1e-5},
       "bfloat16": {"dzx": 4e-3, "f32": 1e-5}}
GRADS = ("dzx", "dR", "dp", "dh0", "dc0")


def _err(got, want):
    """max |got - want| / max(1, max |want|), in float64."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(np.asarray(got, np.float32), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _inputs(b, t, n, dtype="float32", seed=0, peephole=True, masked=False):
    """zx, R, p, h0, c0, mask, g_hs, g_hT, g_cT as numpy arrays in `dtype`
    (mask float32: ragged lengths, row 1 fully masked, row 4 masked in the
    middle of its sequence)."""
    rng = np.random.default_rng(seed)
    npd = NP[dtype]
    arrs = [rng.standard_normal((b, t, 4 * n)) * 0.5,
            rng.standard_normal((n, 4 * n)) * (1.0 / np.sqrt(n)),
            rng.standard_normal((3, n)) * 0.3 if peephole else None,
            rng.standard_normal((b, n)) * 0.5,
            rng.standard_normal((b, n)) * 0.5]
    arrs = [None if a is None else a.astype(npd) for a in arrs]
    mask = None
    if masked:
        lengths = rng.integers(1, t + 1, b)
        mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
        mask[1] = 0.0
        mask[4] = 1.0
        mask[4, t // 3:2 * t // 3] = 0.0
    g = [rng.standard_normal(s).astype(npd)
         for s in ((b, t, n), (b, n), (b, n))]
    return (*arrs, mask, *g)


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _compare(got, want, dtype, names=GRADS):
    tol = TOL[dtype]
    for name, a, w in zip(names, got, want):
        if w is None:
            assert a is None, name
            continue
        limit = tol["dzx"] if name == "dzx" else tol["f32"]
        assert _err(a, w) <= limit, (name, _err(a, w), limit)
        if name == "dzx":
            assert a.dtype == TD[dtype], name
        else:
            assert a.dtype == torch.float32, name


# ------------------------------------------------------------------ row 6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_backward_plain_version_matches_the_pallas_kernel(peephole, masked,
                                                          dtype):
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, 10, 16, dtype, seed=1, peephole=peephole, masked=masked)
    J = [jnp.asarray(a) if a is not None else None
         for a in (zx, R, p, h0, c0, mask)]
    hs = pk._lstm_ref(J[0], J[1], J[3], J[4], J[2], J[5])[0]
    want = pk._lstm_bwd(J[0], J[1], J[3], J[4], hs,
                        (jnp.asarray(ghs), jnp.asarray(ghT),
                         jnp.asarray(gcT)), interpret=True, p=J[2],
                        mask=J[5])
    assert want is not None  # b = 12: the kernel, not the XLA fallback
    got = tlstm.lstm_scan_backward_reference(
        _t(zx), _t(R), _t(h0), _t(c0), _t(np.asarray(hs)), _t(ghs),
        _t(ghT), _t(gcT), _t(p), _t(mask))
    _compare(got, want, dtype)
    # the wrapper takes the plain version for CPU tensors, and counts
    # nothing
    before = tlstm.lstm_scan_bwd.launches
    again = tlstm.lstm_scan_bwd(_t(zx), _t(R), _t(h0), _t(c0),
                                _t(np.asarray(hs)), _t(ghs), _t(ghT),
                                _t(gcT), _t(p), _t(mask))
    assert tlstm.lstm_scan_bwd.launches == before
    for a, w in zip(again, got):
        assert (a is None and w is None) or torch.equal(a, w)


def _autograd_matches_jax_vjp(peephole, masked, chunked):
    """hs, hT, cT and every gradient through the port's scan against
    `jax.vjp` of the JAX package's scan in interpret mode. The chunked
    family runs at t = CHUNK + 6 (a ragged last chunk) against the JAX
    chunked scan in chunks of 14: the chunk length moves the checkpoints,
    not the values or the gradients."""
    t = tlstm.CHUNK + 6 if chunked else 9
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, t, 16, seed=8 if chunked else 3, peephole=peephole,
        masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    jnames = ("lstm_scan_chunked" if chunked else "lstm_scan") \
        + ("_peephole" if peephole else "")
    jscan = getattr(pk, jnames)
    static = (8, 14, True) if chunked else (8, True)
    jargs = tuple(jnp.asarray(a) for a in
                  ((zx, R, p, h0, c0) if peephole else (zx, R, h0, c0)))
    jout, vjp = jax.vjp(lambda *a: jscan(*a, *static, jm), *jargs)
    want = vjp(tuple(jnp.asarray(g) for g in (ghs, ghT, gcT)))
    targs = [_t(a).requires_grad_() for a in
             ((zx, R, p, h0, c0) if peephole else (zx, R, h0, c0))]
    out = getattr(tlstm, jnames)(*targs, _t(mask))
    for o, w in zip(out, jout):
        assert _err(o.detach(), w) <= 1e-5
    got = torch.autograd.grad(out, targs, [_t(g) for g in (ghs, ghT, gcT)])
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and _err(a, w) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_autograd_through_the_scan_matches_jax_vjp(peephole, masked):
    _autograd_matches_jax_vjp(peephole, masked, chunked=False)


# -------------------------------------------------------------- rows 7, 8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_chunked_plain_versions_match_the_pallas_kernels(peephole, masked,
                                                         dtype):
    """b = 12, t = 12 in chunks of 4, as the JAX package's own chunked
    tests run them: hs, hT, cT and the checkpoints hck, cck, then the
    chunked backward from those checkpoints."""
    tc = 4
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, 12, 16, dtype, seed=4, peephole=peephole, masked=masked)
    J = [jnp.asarray(a) if a is not None else None
         for a in (zx, R, p, h0, c0, mask)]
    jf = pk._lstm_chunked(J[0], J[1], J[3], J[4], 8, tc, True, p=J[2],
                          mask=J[5])
    tf = tlstm.lstm_scan_chunked_reference(_t(zx), _t(R), _t(h0), _t(c0),
                                           _t(p), _t(mask), tc=tc)
    assert tf[3].shape == tf[4].shape == (3, 12, 16)
    assert torch.equal(tf[3][0], _t(h0).float())
    names = ("hs", "hT", "cT", "hck", "cck")
    for name, a, w in zip(names, tf, jf):
        want_dtype = TD[dtype] if name in ("hs", "hT", "cT") \
            else torch.float32
        assert a.dtype == want_dtype, name
        limit = 1e-5 if dtype == "float32" or name in ("hck", "cck") \
            else TOL[dtype]["dzx"]
        assert _err(a, w) <= limit, (name, _err(a, w))
    want = pk._lstm_chunked_bwd(J[0], J[1], jf[3], jf[4],
                                (jnp.asarray(ghs), jnp.asarray(ghT),
                                 jnp.asarray(gcT)), 8, tc, True, p=J[2],
                                mask=J[5])
    got = tlstm.lstm_scan_chunked_backward_reference(
        _t(zx), _t(R), _t(np.asarray(jf[3])), _t(np.asarray(jf[4])),
        _t(ghs), _t(ghT), _t(gcT), _t(p), _t(mask), tc=tc)
    _compare(got, want, dtype)


@pytest.mark.parametrize("t", [tlstm.CHUNK, 2 * tlstm.CHUNK + 22])
@pytest.mark.parametrize("masked", [False, True])
def test_the_two_families_give_the_same_values_and_gradients(t, masked):
    """hs, hT, cT and every gradient through `lstm_scan_peephole` (rows 5,
    6) and `lstm_scan_chunked_peephole` (rows 7, 8), including a t that the
    chunk length does not divide."""
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        5, t, 8, seed=5, masked=masked)
    outs, grads = [], []
    for scan in (tlstm.lstm_scan_peephole, tlstm.lstm_scan_chunked_peephole):
        args = [_t(a).requires_grad_() for a in (zx, R, p, h0, c0)]
        out = scan(*args, _t(mask))
        grads.append(torch.autograd.grad(
            out, args, [_t(g) for g in (ghs, ghT, gcT)]))
        outs.append([o.detach() for o in out])
    for a, w in zip(outs[1] + list(grads[1]), outs[0] + list(grads[0])):
        assert _err(a, w.numpy()) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_autograd_through_the_chunked_scan_matches_jax_vjp(peephole, masked):
    _autograd_matches_jax_vjp(peephole, masked, chunked=True)


def test_chunked_checkpoints_are_the_carries_entering_each_chunk():
    zx, R, p, h0, c0, *_ = _inputs(2, 150, 8, seed=6)
    hs, hT, cT, hck, cck = tlstm.lstm_scan_chunked_forward(
        _t(zx), _t(R), _t(h0), _t(c0), _t(p))
    assert hck.shape == cck.shape == (3, 2, 8) and hck.dtype == torch.float32
    for j, s in enumerate((0, 64, 128)):
        _, h, c = tlstm.lstm_scan_reference(
            _t(zx)[:, :s], _t(R), _t(h0), _t(c0), _t(p))
        assert torch.equal(hck[j], h) and torch.equal(cck[j], c)


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regime_predicate_equals_the_jax_package(dtype):
    for b in (1, 8, 16, 17, 64):
        for t in (1, 64, 1023, 1024, 4096):
            for n in (16, 127, 128, 256):
                assert trec.chunked_lstm_auto_regime(b, t, n, TD[dtype]) == \
                    jrec.chunked_lstm_auto_regime(b, t, n, JD[dtype]), \
                    (b, t, n, dtype)


@pytest.mark.parametrize("t,chunked", [(1023, False), (1024, True)])
def test_layer_routes_to_the_chunked_family_in_the_regime(monkeypatch, t,
                                                          chunked):
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM

    called = []
    for name in ("lstm_scan_peephole", "lstm_scan_chunked_peephole"):
        real = getattr(tlstm, name)
        monkeypatch.setattr(trec.lstm_ops, name,
                            lambda *a, _n=name, _f=real: called.append(_n)
                            or _f(*a))
    layer = GravesLSTM(n_out=128, activation="tanh")
    params = layer.init_params(torch.Generator().manual_seed(0),
                               it.recurrent(3, t))
    x = torch.randn(1, t, 3, generator=torch.Generator().manual_seed(1))
    layer.apply(params, x, state={}, train=False)
    assert called == ["lstm_scan_chunked_peephole" if chunked
                      else "lstm_scan_peephole"]


def test_layer_refuses_dropout_in_training():
    """An LSTM layer with dropout: the identity at inference; at train time
    its sequence output takes the dropout after the scan, with the JAX
    layer's mask (its key replayed into the port's draws), and gradients
    through the mask equal JAX's."""
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn.layers import LSTM
    from torch_keys import JaxKeys

    layer = LSTM(n_out=4, activation="tanh", dropout=0.5)
    jlayer = jrec.LSTM(n_out=4, activation="tanh", dropout=0.5)
    params = layer.init_params(torch.Generator().manual_seed(0),
                               it.recurrent(3, 5))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 3)).astype(np.float32))
    plain, _ = layer.scan(params, x, layer.init_carry(2), train=False)
    same, _ = layer.scan(params, x, layer.init_carry(2), train=True)
    torch.testing.assert_close(same, plain, rtol=0, atol=0)
    key = jax.random.PRNGKey(3)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    cot = np.random.default_rng(4).standard_normal((2, 5, 4)).astype(
        np.float32)

    def jfn(p):
        return jlayer.scan(p, jnp.asarray(x.numpy()), jlayer.init_carry(2),
                           train=True, rng=key)[0]

    want, vjp = jax.vjp(jfn, jp)
    (jg,) = vjp(jnp.asarray(cot))
    tp = {k: v.clone().requires_grad_() for k, v in params.items()}
    got, _ = layer.scan(tp, x, layer.init_carry(2), train=True,
                        rng=JaxKeys(key))
    assert int((got == 0).sum()) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(got, list(tp.values()),
                                torch.from_numpy(cot))
    for (k, _), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ contract
def test_cpu_tensors_never_count_a_launch():
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(5, 5, 4, masked=True)
    counters = (tlstm.lstm_scan, tlstm.lstm_scan_bwd, tlstm.lstm_scan_chunked,
                tlstm.lstm_scan_chunked_bwd)
    before = [f.launches for f in counters]
    args = [_t(a).requires_grad_() for a in (zx, R, p, h0, c0)]
    for scan in (tlstm.lstm_scan_peephole, tlstm.lstm_scan_chunked_peephole):
        out = scan(*args, _t(mask))
        torch.autograd.grad(out[0].sum() + out[2].sum(), args)
    hs, _, _, hck, cck = tlstm.lstm_scan_chunked_forward(
        *[_t(a) for a in (zx, R, h0, c0, p, mask)])
    tlstm.lstm_scan_chunked_bwd(_t(zx), _t(R), hck, cck, _t(ghs), _t(ghT),
                                _t(gcT), _t(p), _t(mask))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["g_hs_shape", "g_hT_dtype", "hs_shape",
                                 "hck_shape", "cck_dtype", "p_shape",
                                 "noncontig", "float64", "meta"])
def test_backward_wrappers_refuse_what_they_do_not_take(bad):
    """Each wrapper refuses what it reads (row 6 hs, row 8 the
    checkpoints) and both refuse the rest."""
    zx, R, p, h0, c0, _, ghs, ghT, gcT = _inputs(2, 5, 4)
    a = dict(zx=_t(zx), R=_t(R), p=_t(p), h0=_t(h0), c0=_t(c0),
             g_hs=_t(ghs), g_hT=_t(ghT), g_cT=_t(gcT))
    a["hs"] = tlstm.lstm_scan_reference(a["zx"], a["R"], a["h0"], a["c0"],
                                        a["p"])[0]
    a["hck"] = torch.zeros(1, 2, 4)
    a["cck"] = torch.zeros(1, 2, 4)
    if bad == "g_hs_shape":
        a["g_hs"] = a["g_hs"][:, :4].contiguous()
    elif bad == "g_hT_dtype":
        a["g_hT"] = a["g_hT"].double()
    elif bad == "hs_shape":
        a["hs"] = a["hs"][:1].contiguous()
    elif bad == "hck_shape":
        a["hck"] = torch.zeros(2, 2, 4)
    elif bad == "cck_dtype":
        a["cck"] = a["cck"].bfloat16()
    elif bad == "p_shape":
        a["p"] = a["p"][:2].contiguous()
    elif bad == "noncontig":
        a["g_hs"] = a["g_hs"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "float64":
        for k in ("zx", "R", "p", "h0", "c0", "g_hs", "g_hT", "g_cT", "hs"):
            a[k] = a[k].double()
    else:
        a = {k: v.to("meta") for k, v in a.items()}
    if bad not in ("hck_shape", "cck_dtype"):
        with pytest.raises((TypeError, ValueError)):
            tlstm.lstm_scan_bwd(a["zx"], a["R"], a["h0"], a["c0"], a["hs"],
                                a["g_hs"], a["g_hT"], a["g_cT"], a["p"])
    if bad != "hs_shape":
        with pytest.raises((TypeError, ValueError)):
            tlstm.lstm_scan_chunked_bwd(a["zx"], a["R"], a["hck"], a["cck"],
                                        a["g_hs"], a["g_hT"], a["g_cT"],
                                        a["p"])


# ------------------------------------------- the backward kernels' split
SLOTS = 2  # chunk slots of csrc/lstm_scan_bwd.cu's workspace (kSlots)


def _gates_of(z, c_prev, pv, n):
    i, f, g, o, c_new = tlstm._gates(z, c_prev, None, pv, n)
    return i, f, g, o, c_new


def _run_split(tc, zx, R, p, h0, c0, hs, hck, cck, mask, ghs, ghT, gcT):
    """The split that csrc/lstm_scan_bwd.cu computes, in plain float32
    (TF32 off), in its order through SLOTS chunk slots of tc steps: the
    last chunk recomputed, then, for each chunk j from the last, its
    reverse, its dR, and the recompute of chunk j - 1 into the slot that
    chunk j + 1's dR freed. Phase 1 is a serial recompute from the chunk's
    entry carry or, for row 6 (hs given) without a mask, one product z =
    zx + H R over the chunk's (row, step) pairs with H = (h0, hs_0, ...)
    and a forward scan for c; phase 2 the reverse recurrence, with dp
    summed per (row, unit); dR one product per chunk, added in chunk order.
    Returns (dzx, dR, dp, dh0, dc0) as the kernels do."""
    b, t, n4 = zx.shape
    n = n4 // 4
    zf, Rf = zx.float(), R.float()
    pv = tlstm._peepholes(p, n, zx)
    live = None if mask is None else mask > 0
    products = hs is not None and mask is None
    nt = -(-t // tc)
    slots, dzx = {}, torch.zeros((b, t, n4))
    dR, dpw = None, torch.zeros((3, b, n))
    dh, dc = ghT.float(), gcT.float()

    def span(j):
        s0 = j * tc
        return s0, min(t, s0 + tc)

    def recompute(j):
        s0, s1 = span(j)
        held = slots.get(j % SLOTS)
        assert held is None or held["dR"], "a slot overwritten before its dR"
        c_entry = cck[j] if hck is not None else c0.float()
        if products:
            H = torch.stack([h0.float() if s == 0 else hs[:, s - 1].float()
                             for s in range(s0, s1)], dim=1)
            Z = zf[:, s0:s1] + (H.reshape(-1, n) @ Rf).reshape(b, -1, n4)
            C, c = [], c_entry
            for k in range(s1 - s0):
                c = _gates_of(Z[:, k], c, pv, n)[4]
                C.append(c)
            C = torch.stack(C, dim=1)
        else:
            h = hck[j] if hck is not None else h0.float()
            c = c_entry
            H, Z, C = [], [], []
            for s in range(s0, s1):
                H.append(h)
                z = zf[:, s] + h @ Rf
                _, _, _, o, c_new = _gates_of(z, c, pv, n)
                h_new = o * torch.tanh(c_new)
                if live is not None:
                    m = live[:, s, None]
                    h_new = torch.where(m, h_new, h)
                    c_new = torch.where(m, c_new, c)
                h, c = h_new, c_new
                Z.append(z)
                C.append(c)
            H, Z, C = (torch.stack(x, dim=1) for x in (H, Z, C))
        slots[j % SLOTS] = dict(j=j, H=H, Z=Z, C=C, c_entry=c_entry,
                                      dR=False)

    def reverse(j):
        nonlocal dh, dc
        slot = slots[j % SLOTS]
        assert slot["j"] == j
        s0, s1 = span(j)
        pi, pf, po = pv
        DZ = torch.zeros_like(slot["Z"])
        for k in range(s1 - s0 - 1, -1, -1):
            s = s0 + k
            c_prev = slot["C"][:, k - 1] if k else slot["c_entry"]
            c_new = slot["C"][:, k]
            lv = torch.ones((b, 1), dtype=torch.bool) if live is None \
                else live[:, s, None]
            dh_in = torch.where(lv, ghs[:, s].float() + dh, 0.0)
            dc_in = torch.where(lv, dc, 0.0)
            i, f, g, o, _ = tlstm._gates(slot["Z"][:, k], c_prev, c_new, pv,
                                         n)
            tcn = torch.tanh(c_new)
            dzo = dh_in * tcn * o * (1.0 - o)
            dcc = dh_in * o * (1.0 - tcn * tcn) + dc_in + po * dzo
            dzg = dcc * i * (1.0 - g * g)
            dzi = dcc * g * i * (1.0 - i)
            dzf = dcc * c_prev * f * (1.0 - f)
            DZ[:, k] = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
            dpw.add_(torch.stack([dzi * c_prev, dzf * c_prev, dzo * c_new]))
            dh = DZ[:, k] @ Rf.t() + torch.where(lv, 0.0, dh)
            dc = dcc * f + pi * dzi + pf * dzf + torch.where(lv, 0.0, dc)
        dzx[:, s0:s1] = DZ
        slot["DZ"] = DZ

    def add_dR(j):
        nonlocal dR
        slot = slots[j % SLOTS]
        part = slot["H"].reshape(-1, n).t() @ slot["DZ"].reshape(-1, n4)
        dR = part if j == nt - 1 else dR + part
        slot["dR"] = True

    from deeplearning4j_tpu_torch import dtypes
    with dtypes.exact_float32_matmul():
        recompute(nt - 1)
        for j in range(nt - 1, -1, -1):
            reverse(j)
            add_dR(j)
            if j:
                recompute(j - 1)
    return (dzx.to(zx.dtype), dR, None if p is None else dpw.sum(1), dh,
            dc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_planned_split_matches_the_pallas_backward(peephole, masked, dtype):
    """Row 6's split (one product for z and a c scan without a mask, the
    serial recompute with one) against `_lstm_bwd` in interpret mode."""
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, 10, 16, dtype, seed=9, peephole=peephole, masked=masked)
    J = [jnp.asarray(a) if a is not None else None
         for a in (zx, R, p, h0, c0, mask)]
    hs = pk._lstm_ref(J[0], J[1], J[3], J[4], J[2], J[5])[0]
    want = pk._lstm_bwd(J[0], J[1], J[3], J[4], hs,
                        (jnp.asarray(ghs), jnp.asarray(ghT),
                         jnp.asarray(gcT)), interpret=True, p=J[2],
                        mask=J[5])
    got = _run_split(10, _t(zx), _t(R), _t(p), _t(h0), _t(c0),
                    _t(np.asarray(hs)), None, None, _t(mask), _t(ghs),
                    _t(ghT), _t(gcT))
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
def test_planned_chunked_split_matches_the_pallas_backward(peephole, masked,
                                                           dtype):
    """Row 8's split, chunks of 4 (t = 12), each recomputed one stage ahead
    of its reverse through the slots, against `_lstm_chunked_bwd` in
    interpret mode from the same checkpoints."""
    tc, t = 4, 12
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, t, 16, dtype, seed=10, peephole=peephole, masked=masked)
    J = [jnp.asarray(a) if a is not None else None
         for a in (zx, R, p, h0, c0, mask)]
    jf = pk._lstm_chunked(J[0], J[1], J[3], J[4], 8, tc, True, p=J[2],
                          mask=J[5])
    want = pk._lstm_chunked_bwd(J[0], J[1], jf[3], jf[4],
                                (jnp.asarray(ghs), jnp.asarray(ghT),
                                 jnp.asarray(gcT)), 8, tc, True, p=J[2],
                                mask=J[5])
    got = _run_split(tc, _t(zx), _t(R), _t(p), _t(h0), _t(c0), None,
                    _t(np.asarray(jf[3])), _t(np.asarray(jf[4])), _t(mask),
                    _t(ghs), _t(ghT), _t(gcT))
    _compare(got, want, dtype)


def _chunked_split_matches_the_plain_backward(masked, t, tc=4):
    zx, R, p, h0, c0, mask, ghs, ghT, gcT = _inputs(
        12, t, 16, seed=11, masked=masked)
    args = [_t(a) for a in (zx, R, h0, c0, p, mask)]
    fwd = tlstm.lstm_scan_chunked_reference(*args, tc=tc)
    want = tlstm.lstm_scan_chunked_backward_reference(
        args[0], args[1], fwd[3], fwd[4], _t(ghs), _t(ghT), _t(gcT),
        args[4], args[5], tc=tc)
    got = _run_split(tc, args[0], args[1], args[4], args[2], args[3], None,
                     fwd[3], fwd[4], args[5], _t(ghs), _t(ghT), _t(gcT))
    _compare(got, [w.numpy() for w in want], "float32")


@pytest.mark.parametrize("masked", [False, True])
def test_planned_chunked_split_takes_a_ragged_last_chunk(masked):
    """t = 14 in chunks of 4 (the JAX kernel takes only whole chunks):
    the split against the port's plain chunked backward, which the tests
    above hold against the Pallas kernel."""
    _chunked_split_matches_the_plain_backward(masked, 14)


@pytest.mark.parametrize("t", [1, 3, 4, 5, 7, 8, 9, 12])
@pytest.mark.parametrize("masked", [False, True])
def test_planned_chunked_split_takes_any_number_of_chunks(masked, t):
    """One to three chunks of 4, whole or with a ragged last one, so that
    the split runs with one chunk (no second slot), fills both slots, and
    reuses a slot after its dR: against the port's plain chunked
    backward."""
    _chunked_split_matches_the_plain_backward(masked, t)
