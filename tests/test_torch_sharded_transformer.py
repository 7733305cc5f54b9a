"""The port's ShardedTransformerLM (deeplearning4j_tpu_torch/parallel/
transformer.py) against the JAX package's on the same meshes, from the
JAX params (carried over by `interop.sharded_lm_params_from_jax`) and the
same numpy-seeded tokens: the counterparts of
tests/test_sharded_transformer.py, at its tolerances (losses atol 5e-6,
logits atol 5e-5 / rtol 1e-4).

The port's ranks run as tests/torch_dp_worker.py processes (gloo, a
file:// rendezvous) in two process groups, of two and of four ranks, each
running its cases one after another (`Cases`, started once per module);
JAX runs each mesh on its first virtual devices. The dense config's head
dim is 16 (the ring's hops on the flash kernels' plain versions), the MoE
config's 8 (the online hop). Checkpoints cross both ways across
factorizations: the port's zip, written on data=2 x model=2, resumes in
JAX on model=2 x seq=4, and JAX's, written on data=2 x model=2 x seq=2,
resumes in the port on pipe=2 x seq=2.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel.transformer import (
    ShardedTransformerLM as JLM,
)
from deeplearning4j_tpu.parallel.transformer import (
    TransformerConfig as JConfig,
)
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.parallel import (
    ShardedTransformerLM,
    TransformerConfig,
)
from test_torch_tensor_parallel import Cases, save

LOSS_ATOL, LOGIT_ATOL, LOGIT_RTOL = 5e-6, 5e-5, 1e-4
STEPS = 4
DENSE = dict(vocab=61, d_model=32, n_heads=2, n_layers=2, max_len=64,
             remat=True)
MOE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, max_len=64,
           n_experts=4, remat=True)

# name -> (config, mesh, ranks)
MESHES = {
    "dp2": (DENSE, {"data": 2}),
    "tp2": (DENSE, {"model": 2}),
    "sp2": (DENSE, {"seq": 2}),
    "pp2": (DENSE, {"pipe": 2}),
    "dp2_tp2": (DENSE, {"data": 2, "model": 2}),
    "pp2_sp2": (DENSE, {"pipe": 2, "seq": 2}),
    "moe_ep2": (MOE, {"expert": 2}),
    "moe_pp2_ep2": (MOE, {"pipe": 2, "expert": 2}),
}


def _n(mesh):
    return int(np.prod(list(mesh.values())))


def _data(seed=7, b=8, t=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 61, (b, t)).astype(np.int32),
            rng.integers(0, 61, (b, t)).astype(np.int32))


def _half_weights(ids):
    """Every other token weighted out, and the second half of rows 0-1 (a
    data=2 x seq=2 grid's shard (0, 1)): the shards' totals differ."""
    w = np.ones(ids.shape, np.float32)
    w[:, ::2] = 0.0
    w[:2, 8:] = 0.0
    return w


def _jax_lm(cfg, mesh, seed=0):
    return JLM(JConfig(**cfg), jbuild_mesh(
        JMeshSpec(**mesh), jax.devices()[:_n(mesh)])).init(seed=seed)


def _flat_params(lm):
    return dict(flat_items(jax.tree_util.tree_map(
        np.asarray, jax.device_get(lm.params))))


def _jax_run(cfg, mesh, ids, tgt, w=None, steps=STEPS):
    lm = _jax_lm(cfg, mesh)
    return [lm.fit_batch(ids, tgt, w) for _ in range(steps)], lm.logits(ids)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharded_lm")
    ids, tgt = _data()
    weights = {}
    for name, cfg in (("dense", DENSE), ("moe", MOE)):
        weights[name] = save(base, f"{name}_weights",
                             **_flat_params(_jax_lm(cfg, {"data": 1})))
    data = save(base, "data", ids=ids, tgt=tgt)
    masked = save(base, "masked", ids=ids, tgt=tgt, w=_half_weights(ids))
    # the JAX checkpoint: 2 steps on data=2 x model=2 x seq=2, then 3 more
    jlm = _jax_lm(DENSE, {"data": 2, "model": 2, "seq": 2}, seed=3)
    for _ in range(2):
        jlm.fit_batch(ids, tgt)
    jax_zip = str(base / "jax_lm.zip")
    jlm.save(jax_zip)
    jax_cont = [jlm.fit_batch(ids, tgt) for _ in range(3)]
    specs = {2: {}, 4: {}}
    for name, (cfg, mesh) in MESHES.items():
        specs[_n(mesh)][name] = dict(
            lm=True, config=cfg, mesh=mesh, steps=STEPS, data=data,
            weights=weights["moe" if cfg is MOE else "dense"])
    specs[4]["masked_dp2_sp2"] = dict(
        lm=True, config=DENSE, mesh={"data": 2, "seq": 2}, steps=1,
        data=masked, weights=weights["dense"])
    port_zip = str(base / "port_lm.zip")
    specs[4]["ckpt_save"] = dict(
        lm=True, config=DENSE, mesh={"data": 2, "model": 2}, steps=5,
        save_at=2, save=port_zip, data=data, weights=weights["dense"])
    specs[4]["ckpt_restore"] = dict(
        lm=True, mesh={"pipe": 2, "seq": 2}, steps=3, restore=jax_zip,
        data=data)
    g = {n: Cases(_sub(base, n), n, s) for n, s in specs.items()}
    yield {"groups": g, "ids": ids, "tgt": tgt, "jax_cont": jax_cont,
           "port_zip": port_zip}
    for c in g.values():
        c.stop()


def _sub(base, n):
    d = base / f"g{n}"
    d.mkdir(exist_ok=True)
    return d


@pytest.fixture(scope="module")
def references(groups):
    ids, tgt = groups["ids"], groups["tgt"]
    return {name: _jax_run(cfg, {"data": 1}, ids, tgt)
            for name, cfg in (("dense", DENSE), ("moe", MOE))}


def _result(groups, name, world):
    return groups["groups"][world].result(name)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_jax(groups, references, name):
    """JAX test_mesh_matches_single_device / test_moe_matches_single_device
    on the port's grid: 4 steps' losses and the logits against the JAX
    package on the same mesh and in one device."""
    cfg, mesh = MESHES[name]
    ids, tgt = groups["ids"], groups["tgt"]
    ref_losses, ref_logits = references["moe" if cfg is MOE else "dense"]
    j_losses, j_logits = _jax_run(cfg, mesh, ids, tgt)
    r0 = _result(groups, name, _n(mesh))[0]
    np.testing.assert_allclose(r0["losses"], j_losses, atol=LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(r0["losses"], ref_losses, atol=LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(r0["logits"], j_logits, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(r0["logits"], ref_logits, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    assert r0["losses"][-1] < r0["losses"][0]
    # each rank holds its slice: layers over pipe, heads over model
    heads = cfg["n_heads"] // mesh.get("model", 1)
    layers = cfg["n_layers"] // mesh.get("pipe", 1)
    assert tuple(r0["local_wqkv"]) == (layers, 32, 3, heads,
                                       32 // cfg["n_heads"])


def test_weighted_tokens_masked_out(groups):
    """JAX test_weighted_tokens_masked_out at data=2 x seq=2 with ragged
    weights: the weights' total is the global one, taken outside the
    gradient; the loss equals JAX's and differs from the unweighted
    one."""
    ids, tgt = groups["ids"], groups["tgt"]
    want, _ = _jax_run(DENSE, {"data": 2, "seq": 2}, ids, tgt,
                       _half_weights(ids), steps=1)
    r0 = _result(groups, "masked_dp2_sp2", 4)[0]
    np.testing.assert_allclose(r0["losses"], want, atol=LOSS_ATOL, rtol=0)
    full = _result(groups, "dp2_tp2", 4)[0]["losses"][0]
    assert abs(full - r0["losses"][0]) > 1e-6


def test_port_checkpoint_resumes_in_jax_on_another_mesh(groups):
    """The port's zip, saved after 2 steps on data=2 x model=2, restores
    in the JAX package on model=2 x seq=4 and on data=8, and the next 3
    steps are the port's own continuation."""
    r0 = _result(groups, "ckpt_save", 4)[0]
    ids, tgt = groups["ids"], groups["tgt"]
    cont = r0["losses"][2:]
    for mesh in ({"model": 2, "seq": 4}, {"data": 8}):
        jlm = JLM.restore(groups["port_zip"], jbuild_mesh(
            JMeshSpec(**mesh), jax.devices()[:8]))
        assert jlm.iteration == 2
        got = [jlm.fit_batch(ids, tgt) for _ in range(3)]
        np.testing.assert_allclose(got, cont, atol=LOSS_ATOL, rtol=0)


def test_jax_checkpoint_resumes_in_the_port_on_another_mesh(groups):
    """JAX's zip, saved after 2 steps on data=2 x model=2 x seq=2,
    restores in the port on pipe=2 x seq=2 with its Adam state, and the
    next 3 steps are JAX's continuation."""
    r0 = _result(groups, "ckpt_restore", 4)[0]
    np.testing.assert_allclose(r0["losses"], groups["jax_cont"],
                               atol=LOSS_ATOL, rtol=0)
    assert int(r0["iteration"]) == 5


def test_checkpoint_restores_in_one_process(groups, tmp_path):
    """The port's zip of a grid restores in one process of the port (no
    group: a one-rank grid stand-in) with the grid's params, and without
    the updater the Adam state restarts."""
    from deeplearning4j_tpu_torch.nn import shard as shard_mod

    _result(groups, "ckpt_save", 4)
    one = _one_rank_grid(shard_mod)
    lm = ShardedTransformerLM.restore(groups["port_zip"], one,
                                      device="cpu")
    assert lm.iteration == 2
    assert int(lm.opt_state["t"]) == 2
    jlm = JLM.restore(groups["port_zip"], jbuild_mesh(
        JMeshSpec(data=1), jax.devices()[:1]))
    np.testing.assert_allclose(lm.logits(groups["ids"]),
                               jlm.logits(groups["ids"]),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    fresh = ShardedTransformerLM.restore(groups["port_zip"], one,
                                         load_updater=False, device="cpu")
    assert int(fresh.opt_state["t"]) == 0


def _one_rank_grid(shard_mod):
    """A grid of one rank for a process with no group: every axis of size
    1 runs no collective."""
    axes = {a: shard_mod.AxisGroup(a, None, 0, 1) for a in (
        "data", "fsdp", "model", "pipe", "seq", "expert", "shard",
        "batch", "replica")}
    spec = types.SimpleNamespace(axis_sizes=lambda: {
        a: 1 for a in ("dcn", "data", "fsdp", "model", "pipe", "seq",
                       "expert")})
    return types.SimpleNamespace(
        rank=0, size=1, spec=spec, shape=spec.axis_sizes(),
        axis=lambda name: axes[name], **axes)


def test_constructor_refusals_match_jax():
    """JAX's constructor refusals, with its messages (test_invalid_mesh_
    configs and transformer.py:140-157)."""
    def grid(**sizes):
        shape = {a: sizes.get(a, 1) for a in ("dcn", "data", "fsdp",
                                               "model", "pipe", "seq",
                                               "expert")}
        return types.SimpleNamespace(shape=shape)

    base = TransformerConfig(**DENSE)
    for cfg, g, match in (
            (base, grid(pipe=3), "must divide n_layers"),
            (base, grid(expert=2), "requires n_experts"),
            (base, grid(model=4), "tp=4 must divide n_heads=2"),
            (dataclasses.replace(base, n_heads=3), grid(),
             "n_heads must divide d_model"),
            (TransformerConfig(**MOE), grid(expert=3),
             "ep=3 must divide n_experts=4")):
        with pytest.raises(ValueError, match=match):
            ShardedTransformerLM(cfg, g, device="cpu")
        with pytest.raises(ValueError, match=match):
            jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(
                cfg).items() if k != "dtype"})
            JLM(jcfg, types.SimpleNamespace(shape=g.shape))
