"""The slice as a whole: zoo TransformerLM in the port against the JAX
package's, served by the port's InferenceServer.

The JAX net is built as tests/test_parallel.py builds it (vocab 53, length
16, d_model 32, 4 heads, 2 blocks), given non-trivial LayerNorm gains and
biases, and carried into the port with `interop.params_from_jax`. Both then
run the same token ids made from a seed. Built once per module.

Tolerance: every layer's activation within 1e-5 of that activation's
largest magnitude (float32 on both sides, sums in another order; the JAX
net takes sdpa on the CPU, the port the flash kernel's plain version).
"""
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import Dense, EmbeddingSequence
from deeplearning4j_tpu_torch.serving import (
    InferenceServer,
    NonFiniteOutputError,
)
from deeplearning4j_tpu_torch.zoo import TransformerLM as TTransformerLM

CFG = dict(num_classes=53, max_length=16, d_model=32, n_heads=4, n_layers=2)
TOL = 1e-5


def _ids(n, seed, t=16):
    return np.random.default_rng(seed).integers(0, 53, (n, t)).astype(
        np.int32)


def _perturb(params, rng):
    """Non-trivial LayerNorm gains and all biases, in place."""
    for p in params.values():
        for sub in [p] + [v for v in p.values() if isinstance(v, dict)]:
            for key in list(sub):
                if isinstance(sub[key], dict):
                    continue
                if key == "gamma":
                    sub[key] = rng.uniform(0.5, 1.5, sub[key].shape).astype(
                        np.float32)
                elif key == "beta" or key.startswith("b"):
                    sub[key] = (rng.standard_normal(sub[key].shape) * 0.1
                                ).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(2025)
    jnet = JTransformerLM(**CFG).init()
    params = _perturb(jax.tree_util.tree_map(np.asarray, jnet.params), rng)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tnet = TTransformerLM(**CFG).init(device="cpu")
    interop.params_from_jax(tnet, params, state)
    return jnet, tnet, params, state


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_table(jnet):
    """The JAX table with its nested entries (0-d object arrays holding a
    dict) flattened with '/', as the port's table is."""
    flat = {}

    def put(prefix, v):
        v = v.item() if isinstance(v, np.ndarray) and v.dtype == object else v
        if isinstance(v, dict):
            for k, sub in v.items():
                put(f"{prefix}/{k}", sub)
        else:
            flat[prefix] = np.asarray(v)

    for key, v in jnet.get_param_table().items():
        put(key, v)
    return flat


def test_param_tables_are_identical(nets):
    jnet, tnet, _, _ = nets
    jt, tt = _jax_table(jnet), tnet.get_param_table()
    assert list(tt) == list(jt)
    assert "layer_2/attn/Wqkv" in tt and tt["layer_2/attn/Wqkv"].shape == (
        32, 96)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    assert tnet.num_params() == jnet.num_params()


@pytest.mark.parametrize("ids_dtype", [np.int32, np.float32])
def test_feed_forward_matches_layer_by_layer(nets, ids_dtype):
    jnet, tnet, _, _ = nets
    x = _ids(3, 1).astype(ids_dtype)
    jacts = jnet.feed_forward(x)
    tacts = tnet.feed_forward(x)
    assert len(tacts) == len(jacts) == 2 + CFG["n_layers"] + 2
    assert tacts[0].dtype == torch.from_numpy(x).dtype  # ids stay as given
    for i, (got, want) in enumerate(zip(tacts[1:], jacts[1:])):
        assert tuple(got.shape) == want.shape, i
        assert _rel(got, np.asarray(want)) < TOL, (i, _rel(got, want))


@pytest.mark.parametrize("t", [16, 9])
def test_output_matches(nets, t):
    jnet, tnet, _, _ = nets
    x = _ids(2, t, t=t)
    got = tnet.output(x)
    want = np.asarray(jnet.output(x))
    assert got.shape == (2, t, 53) and got.device.type == "cpu"
    assert _rel(got, want) < TOL
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_config_json_matches_jax():
    jconf = JTransformerLM(**CFG, remat="full").conf()
    tconf = TTransformerLM(**CFG, remat="full").conf()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert [type(l).__name__ for l in back.layers] == [
        "EmbeddingSequence", "PositionEmbedding", "TransformerBlock",
        "TransformerBlock", "RnnOutput"]
    assert back.layers[2].remat == "full"


def test_init_is_seeded_and_distributed_like_jax(nets):
    jnet = nets[0]
    a = TTransformerLM(**CFG).init(device="cpu").get_param_table()
    b = TTransformerLM(**CFG).init(device="cpu").get_param_table()
    c = TTransformerLM(**CFG, seed=5).init(device="cpu").get_param_table()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["layer_0/W"], c["layer_0/W"])
    # learned positions: normal(0, 1/sqrt(f)) * 0.02; xavier elsewhere
    jt = _jax_table(jnet)
    for k, std in (("layer_1/pos", 0.02 / np.sqrt(32)),
                   ("layer_2/attn/Wqkv", np.sqrt(2.0 / (32 + 96))),
                   ("layer_3/W1", np.sqrt(2.0 / (32 + 128)))):
        for table in (a, jt) if k != "layer_1/pos" else (a,):
            assert abs(table[k].std() / std - 1) < 0.15, (k, table[k].std())
    assert np.all(a["layer_2/ln1/gamma"] == 1) and np.all(a["layer_2/b1"] == 0)


def test_server_answers_integer_requests_like_net_output(nets):
    _, tnet, _, _ = nets
    server = InferenceServer(model=tnet, batch_limit=4)
    try:
        server.warmup(_ids(1, 0))
        xs = [_ids(n, 10 + n) for n in (1, 3, 2)]
        reqs = [server.submit(x, deadline_s=60) for x in xs]
        outs = [server.result(r) for r in reqs]
    finally:
        server.shutdown()
    for x, out in zip(xs, outs):
        assert out.shape == (len(x), 16, 53) and out.dtype == np.float32
        np.testing.assert_allclose(out, tnet.output(x).numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert server.snapshot()["breaker"]["state"] == "closed"


def test_server_refuses_an_out_of_range_token_alone(nets):
    """An id past the vocabulary gives NaN rows (as in the JAX package):
    that request fails as non-finite, the next one is answered."""
    _, tnet, _, _ = nets
    bad = _ids(1, 5)
    bad[0, 3] = 53
    server = InferenceServer(model=tnet, batch_limit=1)
    try:
        with pytest.raises(NonFiniteOutputError):
            server.output(bad, deadline_s=60)
        good = server.output(_ids(1, 6), deadline_s=60)
    finally:
        server.shutdown()
    np.testing.assert_allclose(good, tnet.output(_ids(1, 6)).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_zoo_init_builds_a_multi_layer_network_on_the_card_by_default(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTransformerLM(**CFG).init()
    net = TTransformerLM(**CFG).init(device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert net.layer("layer_2").causal and net.device.type == "cpu"


@pytest.mark.parametrize("fault", ["missing_layer", "extra_nested_key",
                                   "bad_nested_shape", "flat_block"])
def test_params_from_jax_rejects_mismatches(nets, fault):
    _, _, params, state = nets
    tnet = TTransformerLM(**CFG).init(device="cpu")
    params = jax.tree_util.tree_map(lambda a: a, params)  # deep copy
    if fault == "missing_layer":
        del params["layer_4"]
    elif fault == "extra_nested_key":
        params["layer_2"]["attn"]["extra"] = np.zeros(3, np.float32)
    elif fault == "bad_nested_shape":
        params["layer_3"]["ln2"]["gamma"] = np.ones(31, np.float32)
    else:
        params["layer_2"] = {"W1": params["layer_2"]["W1"]}
    before = tnet.get_param_table()["layer_2/attn/Wqkv"]
    with pytest.raises(ValueError):
        interop.params_from_jax(tnet, params, state)
    np.testing.assert_array_equal(tnet.get_param_table()["layer_2/attn/Wqkv"],
                                  before)


def test_multi_layer_configuration_validates_and_infers_types():
    conf = NeuralNetConfiguration(seed=1).list([
        EmbeddingSequence(n_in=10, n_out=4), Dense(n_out=3)])
    types = conf.layer_input_types()  # n_in on a sequence-first layer
    assert types[0] == it.recurrent(10) and types[-1] == it.recurrent(3)
    with pytest.raises(ValueError, match="no layers"):
        NeuralNetConfiguration().list([]).validate()
    with pytest.raises(ValueError, match="input_type"):
        NeuralNetConfiguration().list([Dense(n_out=3)]).validate()
    with pytest.raises(ValueError, match="name no layer"):
        conf.input_preprocessor(5, object()).validate()
    # preprocessors are ported: from_json reads them
    read = MultiLayerConfiguration.from_json({
        "defaults": {}, "layers": [], "input_type": None,
        "input_preprocessors": {"0": {"type": "RnnToFeedForward"}}})
    assert type(read.input_preprocessors[0]).__name__ == "RnnToFeedForward"
    with pytest.raises(KeyError, match="NoSuchPreprocessor"):
        MultiLayerConfiguration.from_json({
            "defaults": {}, "layers": [], "input_type": None,
            "input_preprocessors": {"0": {"type": "NoSuchPreprocessor"}}})
