"""The port's placement tables against the JAX package's: every layer's
`tensor_partition_specs` (tuples against the JAX PartitionSpecs' entries)
and the fsdp layout `parallel.layout.fsdp_param_specs` (the layer specs
with `SpecLayout.extend` composed on) at model and fsdp sizes 1, 2 and 4,
on networks built by both packages from one config JSON; the JAX side on
a mesh over the conftest's virtual devices where fsdp x model <= 8 (its
helpers need one), `SpecLayout.extend` and `drop_fsdp` on their own at
every size. Each spec is over the param's interchange layout (HWIO conv
kernels), so the tables compare entry for entry."""
import types

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel import layout as jlayout
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.training import engine as jengine
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    BatchNorm,
    CenterLossOutput,
    Conv1D,
    Conv2D,
    Deconv2D,
    Dense,
    ElementWiseMultiplication,
    Embedding,
    EmbeddingSequence,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LastTimeStep,
    LayerNorm,
    MultiHeadAttention,
    Output,
    PositionEmbedding,
    RnnOutput,
    SeparableConv2D,
    SimpleRnn,
    Subsampling2D,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.parallel import MeshSpec
from deeplearning4j_tpu_torch.parallel import layout as layout_mod
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.training import engine
from test_torch_parallel import jax_net, port_net

SIZES = (1, 2, 4)


def _nets():
    """Config JSONs that hold every layer that declares a split, with
    widths that divide by 1, 2 and 4, by 2 only, and by neither."""
    cnn = NeuralNetConfiguration(seed=1).list([
        Conv2D(kernel_size=(3, 3), n_out=8, convolution_mode="same"),
        SeparableConv2D(kernel_size=(3, 3), n_out=6,
                        convolution_mode="same", depth_multiplier=2),
        Deconv2D(kernel_size=(2, 2), stride=(2, 2), n_out=4,
                 convolution_mode="same"),
        BatchNorm(),
        Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
        Dense(n_out=12, activation="relu"),
        ElementWiseMultiplication(n_out=12),
        Output(n_out=4, loss="mcxent"),
    ]).set_input_type(it.convolutional(8, 8, 4))
    rnn = NeuralNetConfiguration(seed=2).list([
        Conv1D(kernel_size=3, n_out=8, convolution_mode="same"),
        LSTM(n_out=8),
        GravesLSTM(n_out=6),
        GravesBidirectionalLSTM(n_out=4),
        SimpleRnn(n_out=6),
        RnnOutput(n_out=3, loss="mcxent"),
    ]).set_input_type(it.recurrent(5, 6))
    lm = NeuralNetConfiguration(seed=3).list([
        EmbeddingSequence(n_in=12, n_out=16),
        PositionEmbedding(max_len=8),
        TransformerBlock(n_heads=4),
        MultiHeadAttention(n_heads=2),
        LayerNorm(),
        RnnOutput(n_out=12, loss="mcxent", activation="softmax"),
    ]).set_input_type(it.recurrent(12, 8))
    misc = NeuralNetConfiguration(seed=4).list([
        Embedding(n_in=10, n_out=8),
        Dense(n_out=6, activation="tanh"),
        CenterLossOutput(n_out=4, loss="mcxent"),
    ]).set_input_type(it.feed_forward(1))
    last = NeuralNetConfiguration(seed=5).list([
        LastTimeStep(underlying=LSTM(n_out=8)),
        Output(n_out=3, loss="mcxent"),
    ]).set_input_type(it.recurrent(4, 5))
    return {k: v.to_json() for k, v in dict(cnn=cnn, rnn=rnn, lm=lm,
                                             misc=misc, last=last).items()}


NETS = _nets()


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, conf in NETS.items():
        jnet = jax_net("mln", conf)
        out[name] = (jnet, port_net("mln", conf, jnet))
    return out


def _jax_flat(tree):
    """{path: spec tuple} of a nested dict of PartitionSpecs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _jax_flat(v).items()})
        else:
            out[k] = tuple(v)
    return out


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("m", SIZES)
def test_layer_specs_equal_jax(pairs, name, m):
    """Each layer's tensor_partition_specs, entry for entry."""
    jnet, tnet = pairs[name]
    split = 0
    for i, (jl, tl) in enumerate(zip(jnet.layers, tnet.layers)):
        k = f"layer_{i}"
        want = _jax_flat(jl.tensor_partition_specs(jnet.params[k], "model",
                                                   m))
        got = dict(flat_items(tl.tensor_partition_specs(tnet.params[k],
                                                        "model", m)))
        assert got == want, (name, k, type(tl).__name__)
        split += sum(bool(s) for s in got.values())
    assert (split > 0) == (m > 1)


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("f", SIZES)
@pytest.mark.parametrize("m", SIZES)
def test_fsdp_param_specs_equal_jax(pairs, name, f, m):
    """fsdp_param_specs (the layer specs with the fsdp axis composed on),
    per param, as the JAX package's."""
    jnet, tnet = pairs[name]
    grid = types.SimpleNamespace(shape=MeshSpec(fsdp=f, model=m)
                                 .axis_sizes())
    got = {k: {p: pl.spec for p, pl in tree.items()} for k, tree in
           layout_mod.fsdp_param_specs(grid, tnet).items()}
    if f * m > len(jax.devices()):
        # no JAX mesh that size here: the layer specs through the JAX
        # SpecLayout.extend over the interchange shapes
        want = {}
        for i, jl in enumerate(jnet.layers):
            k = f"layer_{i}"
            specs = _jax_flat(jl.tensor_partition_specs(jnet.params[k],
                                                        "model", m))
            shapes = dict(flat_items(jax.tree_util.tree_map(
                np.shape, jnet.params[k])))
            want[k] = {p: tuple(jlayout.DEFAULT_LAYOUT.extend(
                jax.sharding.PartitionSpec(*s), shapes[p], f))
                for p, s in specs.items()}
    else:
        mesh = jbuild_mesh(JMeshSpec(fsdp=f, model=m),
                           devices=jax.devices()[:f * m])
        want = {k: _jax_flat(t) for k, t in
                jlayout.fsdp_param_specs(mesh, jnet).items()}
    assert got == want


@pytest.mark.parametrize("f", SIZES)
def test_spec_layout_extend_and_drop_as_jax(f):
    """SpecLayout.extend picks the first of the largest free dims the fsdp
    axis divides; drop_fsdp strips it again."""
    P = jax.sharding.PartitionSpec
    shapes = [(8,), (12, 8), (8, 12), (8, 8), (3, 3, 8, 8), (1, 1, 6, 4),
              (4, 16), (16, 4), (2, 6), (6, 6), (12, 4, 4)]
    for shape in shapes:
        for spec in [(), (None, "model"), ("model",),
                     (None,) * (len(shape) - 1) + ("model",)]:
            if len(spec) > len(shape):
                continue
            want = tuple(jlayout.DEFAULT_LAYOUT.extend(P(*spec), shape, f))
            got = layout_mod.DEFAULT_LAYOUT.extend(spec, shape, f)
            assert got == want, (shape, spec, f)
            assert (layout_mod.DEFAULT_LAYOUT.drop_fsdp(got)
                    == tuple(jlayout.DEFAULT_LAYOUT.drop_fsdp(P(*want))))


def test_generic_rule_and_helpers_as_jax():
    """param_partition_spec, batch_sharding and mirror_opt_shardings."""
    for shape in [(), (8,), (8, 8), (4, 6), (3, 3, 4, 8), (2, 3)]:
        for m in SIZES:
            assert mesh_mod.param_partition_spec("p", shape, m) == tuple(
                jmesh.param_partition_spec("p", shape, m))
    assert mesh_mod.batch_sharding(None, 3).spec == ("data", None, None)
    placements = {"W": mesh_mod.Placement((None, "model")),
                  "b": mesh_mod.Placement(("model",))}
    slots = {"m": {"W": 0, "b": 0}, "v": {"W": 0, "b": 0}, "t": 0}
    mirror = mesh_mod.mirror_opt_shardings(None, slots, placements)
    assert mirror["m"] == mirror["v"] == placements
    assert mirror["t"] is mesh_mod.REPLICATED


def test_scan_carry_specs_reach_their_fixed_point(pairs):
    """engine.scan_carry_specs: None without a sharded layout; with one,
    the carry's specs out equal its specs in, as the JAX engine's."""
    jnet, tnet = pairs["lm"]
    assert engine.scan_carry_specs(tnet) is None
    assert jengine.scan_carry_specs(jnet) is None
    # rank 0 of a 2 x 2 grid, its slices cut without a process group
    axes = {a: shard_mod.AxisGroup(a, None, 0, 2) for a in ("fsdp",
                                                            "model")}
    grid = types.SimpleNamespace(
        shape=MeshSpec(fsdp=2, model=2).axis_sizes(), axis=axes.get, **axes)
    arr = layout_mod.FsdpArrangement(
        grid, layout_mod.fsdp_param_specs(grid, tnet))
    whole = tnet.params
    tnet.params, tnet._shard_layout = arr.shard_tree(whole), arr
    try:
        ins, outs = engine.scan_carry_specs(tnet)
    finally:
        tnet.params, tnet._shard_layout = whole, None
    assert ins == outs == arr.specs
    assert any(s for t in ins.values() for s in t.values())
