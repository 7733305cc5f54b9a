"""The port's fsdp axis (ZeRO-3: params and updater slots sharded at rest,
gathered on use) and its remat policies against the JAX package
(tests/test_fsdp.py's counterparts).

The fsdp cases run on four worker ranks at MeshSpec(fsdp=2, model=2) in
one process group (tests/test_torch_tensor_parallel.py's `Cases`); each
test runs the JAX ParallelWrapper on the same mesh over four virtual
devices and the port's single process here. Tolerances: the JAX fsdp
parity test's 1e-4 on the score and the params
(test_fsdp_fit_parity_vs_replicated), the tp MLP's rtol 2e-4 / atol 2e-5
(test_tp_matches_single_device), resume 1e-6
(test_fsdp_resume_windowed_k4), the remat policies 1e-5
(test_policies_train_to_same_loss).
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.parallel import layout as jlayout
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.nn.layers.base import (
    current_iteration,
    iteration_scope,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    EmbeddingSequence,
    PositionEmbedding,
    RnnOutput,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelWrapper,
)
from deeplearning4j_tpu_torch.parallel import layout as layout_mod
from test_torch_parallel import (
    jax_net,
    jax_results,
    max_err,
    port_fit,
    port_net,
)
import test_torch_tensor_parallel as tp
from test_torch_tensor_parallel import (
    Cases,
    jax_fit,
    local,
    save,
    save_weights,
)
from torch_dp_worker import Tape, results

FSDP_TP = {"fsdp": 2, "model": 2}
VOCAB = 64


def _lm_conf(remat=None, seed=7):
    return tzoo.TransformerLM(num_classes=VOCAB, max_length=16, d_model=32,
                              n_heads=4, n_layers=2, remat=remat,
                              seed=seed).conf()


def _lm_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (n, 16)).astype(np.float32)
    return ids, np.eye(VOCAB, dtype=np.float32)[
        rng.integers(0, VOCAB, (n, 16))]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    base = tmp_path_factory.mktemp("fsdp")
    lm = _lm_conf().to_json()
    jlm = jax_net("mln", lm)
    x, y = _lm_data()
    lm_case = dict(kind="mln", conf=lm, weights=save_weights(base, "lm", jlm),
                   data=save(base, "lm", x=x, y=y), batch=32, epochs=2,
                   mesh=FSDP_TP)
    # the weights every case starts from (jax_fit trains jlm in place),
    # and a whole table that differs from them
    start = port_net("mln", lm, jlm).get_param_table()
    table = {k: 0.9 * v + 0.01 for k, v in start.items()}
    np.savez(base / "table.npz", **table)
    specs = {
        "lm": dict(lm_case, sync=True),
        "lm_full": dict(lm_case, remat="full"),
        "table": dict(lm_case, table=str(base / "table.npz")),
        "resume": dict(lm_case, batch=8, epochs=4, window=4,
                       resume=str(base / "ckpt")),
        "refactor": dict(lm_case, batch=8, epochs=4,
                         resume=str(base / "ckpt2"),
                         resume_mesh={"data": 2, "model": 2}),
    }
    group = Cases(base, 4, specs)
    yield {"group": group, "jlm": jlm, "lm": lm, "start": start,
           "table": table}
    group.stop()


@pytest.fixture(scope="module")
def tp_cases(tmp_path_factory):
    """tests/test_torch_tensor_parallel.py's cases at fsdp x model."""
    c = tp.start_cases(tmp_path_factory.mktemp("fsdp_tp"), FSDP_TP,
                       ["mlp", "mlp_reg", "lm", "lm_drop", "graph", "lstm",
                        "tfscope", "vgg"])
    yield c
    c["group"].stop()


@pytest.mark.parametrize("name", ["mlp", "mlp_reg", "lm", "lm_drop",
                                  "graph", "lstm", "tfscope", "vgg"])
def test_fsdp_tp_matches_jax_and_single_process(tp_cases, name):
    """The dp x tp cases (the MLP, with l1, l2 and clipped gradients too,
    the TransformerLM, with FFN dropout too, the graph, the LSTM char-RNN,
    the imported Keras net, VGG16) at fsdp=2 x model=2 against
    the JAX wrapper on the same mesh and the port's single process, at
    the same tolerances; the kernels split over both axes where a free
    dim divides."""
    getattr(tp, f"check_{name}")(tp_cases)


def test_fsdp_fit_parity_vs_replicated(cases):
    """JAX test_fsdp_fit_parity_vs_replicated: the TransformerLM at fsdp=2
    x model=2, 2 epochs of one batch of 32, against the JAX wrapper on the
    same mesh and the port's single process: fsdp changes where the bytes
    live, not what is computed."""
    x, y = _lm_data()
    tnet = port_net("mln", cases["lm"], cases["jlm"])
    ts = port_fit(tnet, (x, y), 32, 2)
    js = jax_fit(cases["jlm"], FSDP_TP, (x, y), 32, 2)
    r0 = cases["group"].result("lm")[0]
    assert np.isfinite(r0["scores"]).all()
    assert abs(r0["scores"][-1] - js[-1]) < 1e-4
    assert abs(r0["scores"][-1] - ts[-1]) < 1e-4
    assert max_err(r0, jax_results(cases["jlm"]), "param/") <= 1e-4
    assert max_err(r0, results(tnet, ts), "param/") <= 1e-4


def test_fsdp_params_sharded_at_rest(cases):
    """JAX test_fsdp_params_sharded_at_rest: every rank holds less than the
    whole params and updater slots; the embedding table splits its vocab
    over 'fsdp' (and its width over 'model')."""
    for r in cases["group"].result("lm"):
        held = sum(int(v) for k, v in r.items()
                   if k.startswith("local/param/"))
        whole = sum(v.size for k, v in r.items() if k.startswith("param/"))
        assert held < whole / 2
        slots = sum(int(v) for k, v in r.items()
                    if k.startswith("local/slot/"))
        assert slots < sum(v.size for k, v in r.items()
                           if k.startswith("slot/")) / 2
        assert local(r, "layer_0/W") == VOCAB * 32 // 4


def test_set_param_table_on_a_sharded_network_keeps_its_slices(cases):
    """set_param_table on a network wrapped at fsdp=2 x model=2 takes whole
    arrays, as get_param_table gives them, and each rank keeps its
    slices: the fit that follows equals the port's single process given
    the same table (the fsdp parity tolerance, 1e-4)."""
    x, y = _lm_data()
    tnet = port_net("mln", cases["lm"], cases["jlm"])
    tnet.set_param_table(cases["table"])
    ts = port_fit(tnet, (x, y), 32, 2)
    r0 = cases["group"].result("table")[0]
    np.testing.assert_allclose(r0["scores"], ts, atol=1e-4)
    assert max_err(r0, results(tnet, ts), "param/") <= 1e-4
    assert local(r0, "layer_0/W") == VOCAB * 32 // 4


def test_fsdp_gathers_again_inside_the_remat_scope(cases):
    """Under remat 'full' each layer's fsdp gather runs inside its
    checkpoint, so the backward gathers again (more fsdp collectives) and
    the run equals the one without remat."""
    plain = cases["group"].result("lm")[0]
    full = cases["group"].result("lm_full")[0]
    assert int(full["coll/fsdp"]) > int(plain["coll/fsdp"])
    assert max_err(full, plain, "param/") <= 1e-6
    np.testing.assert_allclose(full["scores"], plain["scores"], rtol=1e-6)


def test_fsdp_resume_windowed_k4(cases):
    """JAX test_fsdp_resume_windowed_k4: fit 2 epochs, a new network and
    wrapper restored from the checkpoint fit to 4, under fsdp x model with
    step windows of 4, equal an unbroken fit of 4 epochs."""
    r0 = cases["group"].result("resume")[0]
    assert int(r0["epoch"]) == int(r0["control/epoch"]) == 4
    assert int(r0["iteration"]) == int(r0["control/iteration"]) == 16
    assert int(r0["windows"]) > 0
    control = {k[len("control/"):]: v for k, v in r0.items()
               if k.startswith("control/")}
    assert max_err(r0, control, "param/") <= 1e-6


def test_checkpoint_restores_into_another_factorization(cases):
    """A checkpoint written at fsdp=2 x model=2 (whole params, gathered)
    restores into data=2 x model=2 and trains on: 2 + 2 epochs equal an
    unbroken fit of 4 at fsdp x model to float32 rounding (the two grids
    sum in other orders; 1e-5)."""
    r0 = cases["group"].result("refactor")[0]
    assert int(r0["epoch"]) == int(r0["control/epoch"]) == 4
    control = {k[len("control/"):]: v for k, v in r0.items()
               if k.startswith("control/")}
    assert max_err(r0, control, "param/") <= 1e-5


def test_sync_to_host_leaves_whole_params_on_every_rank(cases):
    """After sync_to_host every rank holds the whole params, equal to the
    table gathered before it, and no layout; a later fit places them
    again and takes the single process's third epoch (1e-4)."""
    x, y = _lm_data()
    tnet = port_net("mln", cases["lm"], cases["jlm"])
    tnet.set_param_table(cases["start"])
    ts = port_fit(tnet, (x, y), 32, 3)
    for r in cases["group"].result("lm"):
        assert bool(r["synced_whole"])
        for k in r:
            if k.startswith("synced/"):
                np.testing.assert_array_equal(r[k],
                                              r["param/" + k[len("synced/"):]])
        assert bool(r["refit_sliced"])
        assert abs(float(r["refit_score"]) - ts[2]) < 1e-4


def test_fsdp_rejects_seq_pipe_and_tbptt_composition():
    """JAX test_fsdp_rejects_seq_and_pipe_composition and the wrapper's
    other refusals, raised before any group exists; the dcn, seq, pipe
    and expert axes pass every refusal and reach the grid, which asks for
    a process group."""
    net = tzoo.TransformerLM(num_classes=VOCAB, max_length=16, d_model=32,
                             n_heads=4, n_layers=1).init(device="cpu")
    for spec in (MeshSpec(fsdp=4, seq=2), MeshSpec(fsdp=2, pipe=2)):
        with pytest.raises(ValueError, match="fsdp"):
            ParallelWrapper(net, mesh_spec=spec)
    with pytest.raises(ValueError, match="pipe x model"):
        ParallelWrapper(net, mesh_spec=MeshSpec(data=2, pipe=2, model=2))
    conf = NeuralNetConfiguration(
        seed=1, backprop_type="tbptt", tbptt_fwd_length=4).list([
            LSTM(n_out=8), RnnOutput(n_out=4, loss="mcxent"),
        ]).set_input_type(it.recurrent(4, 8))
    rnn = MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="fsdp"):
        ParallelWrapper(rnn, mesh_spec=MeshSpec(fsdp=2))
    for spec in (MeshSpec(data=2, seq=2), MeshSpec(data=2, pipe=2)):
        with pytest.raises(ValueError, match="truncated BPTT"):
            ParallelWrapper(rnn, mesh_spec=spec)
    for spec in (MeshSpec(dcn=2), MeshSpec(seq=2), MeshSpec(pipe=2),
                 MeshSpec(expert=2)):
        with pytest.raises(RuntimeError, match="no process group"):
            ParallelWrapper(net, mesh_spec=spec)


class TestRematPolicies:
    def test_canonical_policy_as_jax(self):
        for sel in (True, False, None, "none", "dots_saveable", "full",
                    "offload"):
            assert (layout_mod.canonical_policy(sel)
                    == jlayout.canonical_policy(sel))
        assert layout_mod.REMAT_POLICY_NAMES == jlayout.REMAT_POLICY_NAMES
        with pytest.raises(ValueError):
            layout_mod.canonical_policy("bogus")

    def test_policies_train_to_same_loss(self):
        """JAX test_policies_train_to_same_loss: every policy's 2-epoch
        score agrees with no remat (and with the JAX package's)."""
        x, y = _lm_data(n=8)
        ds = DataSet(x, y)
        jnet = jax_net("mln", _lm_conf().to_json())
        nets = {pol: port_net("mln", _lm_conf(remat=pol).to_json(), jnet)
                for pol in layout_mod.REMAT_POLICY_NAMES}
        jnet.fit(JDataSet(x, y), epochs=2)
        jscore = jnet.score(JDataSet(x, y))
        scores = {}
        for pol, net in nets.items():
            net.fit(ListDataSetIterator(ds, batch=8), epochs=2)
            scores[pol] = net.score(ds)
        for pol, s in scores.items():
            assert abs(s - scores["none"]) < 1e-5, (pol, s)
        assert abs(scores["none"] - jscore) < 1e-5

    @pytest.mark.parametrize("policy", ["full", "dots_saveable"])
    def test_recompute_takes_the_forward_threads_step_state(self, policy):
        """On a CUDA tensor the backward, and so a checkpoint's recompute,
        runs on autograd's device thread, which holds none of the calling
        thread's step state. With the backward run on another thread, as
        there, the recompute still sees the forward's installed and
        active batch shard and its iteration, and the gradient is the
        forward's."""
        shard = shard_mod.BatchShard(group=None, rank=0, world=1, rows=3,
                                     unpadded=3)
        seen = []

        def fn(x, rng=None):
            it_now = current_iteration()
            seen.append((shard_mod.current(), it_now))
            return x * x * (1.0 if it_now is None else float(it_now))

        x = torch.arange(3, dtype=torch.float32, requires_grad=True)
        with shard_mod.installed(shard), shard_mod.active(), \
                iteration_scope(5):
            y = layout_mod.maybe_remat(fn, policy)(x).sum()
        errors = []

        def backward():
            try:
                y.backward()
            except Exception as e:  # surfaced below
                errors.append(e)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        assert not errors, errors
        assert seen == [(shard, 5), (shard, 5)]
        torch.testing.assert_close(x.grad, 10.0 * x.detach(), rtol=0,
                                   atol=0)

    def test_dropout_masks_replay_bit_for_bit_under_remat(self):
        """A TransformerBlock with FFN dropout under 'full' and
        'dots_saveable': the recompute replays the forward's masks, so the
        masks drawn and the params after 2 steps are those of 'none', bit
        for bit."""
        x, y = _lm_data(n=4)
        out = {}
        for pol in ("none", "full", "dots_saveable"):
            conf = NeuralNetConfiguration(
                seed=3, updater=updaters.Adam(learning_rate=1e-3),
                weight_init="xavier").list([
                    EmbeddingSequence(n_in=VOCAB, n_out=32),
                    PositionEmbedding(max_len=16),
                    TransformerBlock(n_heads=4, causal=True, dropout=0.7,
                                     remat=pol),
                    RnnOutput(n_out=VOCAB, loss="mcxent",
                              activation="softmax"),
                ]).set_input_type(it.recurrent(VOCAB, 16))
            net = MultiLayerNetwork(conf).init(device="cpu")
            tape = Tape.record(Draws.seeded(3, "cpu"))
            net.draws = tape
            net.fit(ListDataSetIterator(DataSet(x, y), batch=4), epochs=2)
            out[pol] = ([t for _, t in tape.tape], net.get_param_table())
        masks, table = out["none"]
        assert len(masks) == 2
        for pol in ("full", "dots_saveable"):
            assert len(out[pol][0]) == 2  # drawn once per step, replayed
            for a, b in zip(masks, out[pol][0]):
                assert torch.equal(a, b)
            for k in table:
                np.testing.assert_array_equal(out[pol][1][k], table[k],
                                              err_msg=f"{pol} {k}")

