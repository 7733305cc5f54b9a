"""The port's ring attention (deeplearning4j_tpu_torch/parallel/ring.py)
against the JAX package's `parallel.ring.ring_attention` on the same
numpy-seeded inputs, forward and the gradients of sum(o * w), at
tests/test_attention.py's 2e-5.

The port's ranks run as tests/torch_dp_worker.py processes (gloo, a
file:// rendezvous), every case of this file one after another in one
process group of four (`Cases`, started once per module); JAX runs the
same mesh on the first four virtual devices. Head dim 16 without a mask
takes the kernel route (the flash kernels' plain versions on the CPU);
head dim 8, or a mask, takes the online hop, with and without
`block_size` sub-chunks.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel import ring as jring
from test_torch_tensor_parallel import Cases, save

TOL = 2e-5
B, H, T = 2, 4, 32

# name -> (mesh, causal, masked, block_size, head dim)
CASES = {
    f"{'c' if causal else 'n'}_{'m' if masked else 'u'}_b{bs or 0}_d{d}":
        ({"seq": 4}, causal, masked, bs, d)
    for causal, masked, bs, d in itertools.product(
        (True, False), (False, True), (None, 4), (8, 16))
}
CASES["dp_c_u_d16"] = ({"data": 2, "seq": 2}, True, False, None, 16)
CASES["dp_c_m_d8"] = ({"data": 2, "seq": 2}, True, True, None, 8)


def _inputs(name, seed):
    mesh, causal, masked, bs, d = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, T, d)).astype(np.float32)
                  for _ in range(4))
    mask = None
    if masked:
        mask = (rng.random((B, T)) > 0.25).astype(np.float32)
        mask[0, 20:] = 0.0  # a dead tail: the last shard wholly masked
    return q, k, v, w, mask


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    base = tmp_path_factory.mktemp("ring")
    specs = {}
    for i, (name, (mesh, causal, masked, bs, d)) in enumerate(CASES.items()):
        q, k, v, w, mask = _inputs(name, i)
        specs[name] = dict(ring=True, mesh=mesh, causal=causal,
                           block_size=bs,
                           data=save(base, name, q=q, k=k, v=v, w=w,
                                     mask=mask))
    g = Cases(base, 4, specs)
    yield g
    g.stop()


def _jax_ring(name, seed):
    mesh, causal, masked, bs, d = CASES[name]
    q, k, v, w, mask = _inputs(name, seed)
    n = int(np.prod(list(mesh.values())))
    jmesh = jbuild_mesh(JMeshSpec(**mesh), devices=jax.devices()[:n])
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jring.ring_attention(q, k, v, jmesh, mask=m, causal=causal,
                                 block_size=bs)
        return (o * w).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_attention_matches_jax(group, name):
    """Forward and dq, dk, dv against JAX's ring on the same mesh, every
    rank alike."""
    seed = list(CASES).index(name)
    o, grads = _jax_ring(name, seed)
    ranks = group.result(name)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["o"], o, atol=TOL, rtol=TOL)
    for n, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(r0[n], g, atol=TOL, rtol=TOL, err_msg=n)
    mesh, causal, masked, bs, d = CASES[name]
    assert bool(r0["kernel_route"]) == (not masked and d == 16)


def test_ring_hops_per_call(group):
    """The K/V hops: n - 1 of each of k and v forward; backward n - 1 of
    each of k and v and n of each of dk and dv on the kernel route (the
    partials' last hop returns them to their owner), n - 1 of each of dk
    and dv on the online route (the inverse rotations); plus the output's
    all-gather and the inputs' gradient all-gathers of `ring_attention`
    over global tensors. At seq = 4: 2*3 + 2*3 + 2*4 + 1 + 3 = 24 and
    2*3 + 2*3 + 1 + 3 = 16 (+ 3 mask hops)."""
    got = {name: int(group.result(name)[0]["hops"]) for name in
           ("c_u_b0_d16", "c_u_b0_d8", "c_m_b0_d8")}
    assert got == {"c_u_b0_d16": 24, "c_u_b0_d8": 16, "c_m_b0_d8": 19}


@pytest.mark.parametrize("mode", ["learned", "sincos"])
def test_position_embedding_indexes_global_offsets(mode):
    """Under `sequence_parallel`, each shard's PositionEmbedding adds the
    table's rows at its global offset (learned and sincos), so the shards
    join to the unsharded output; a global length past max_len raises
    JAX's message."""
    import torch

    from deeplearning4j_tpu_torch.nn import shard as shard_mod
    from deeplearning4j_tpu_torch.nn.layers import PositionEmbedding
    from deeplearning4j_tpu_torch.parallel import ring

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 8, generator=gen)
    layer = PositionEmbedding(max_len=16, mode=mode)
    params = ({"pos": torch.randn(16, 8, generator=gen)}
              if mode == "learned" else {})
    whole = layer.apply(params, x, state={}, train=False)[0]
    for r in range(4):
        with ring.sequence_parallel(shard_mod.AxisGroup("seq", None, r, 4)):
            part = layer.apply(params, x[:, 4 * r:4 * r + 4], state={},
                               train=False)[0]
        torch.testing.assert_close(part, whole[:, 4 * r:4 * r + 4],
                                   rtol=0, atol=0)
    with ring.sequence_parallel(shard_mod.AxisGroup("seq", None, 0, 8)):
        with pytest.raises(ValueError, match="sequence length 32 exceeds "
                           "PositionEmbedding max_len=16"):
            layer.apply(params, x[:, :4], state={}, train=False)
