"""Numerical gradient checker (counterpart of
deeplearning4j_tpu/util/gradientcheck.py; gradientcheck/
GradientCheckUtil.java): central-difference gradients per parameter
against the analytic gradient, in float64 with exact float64 products.

The analytic gradient is `torch.autograd.grad` of the network's inference
loss (`_loss(..., train=False)`: the output layer's loss under the masks
plus the l1/l2 penalty), on float64 copies of the params on the network's
device. In float64 every layer takes its plain version: the kernels take
float32 and bfloat16 only.

Entries are probed leaf by leaf in the JAX package's leaf order (the
sorted key paths of the params, as `models.serialization` writes them) and
in the interchange layout (a Conv2D kernel's HWIO, whatever the port holds
it in), and the subsample of each leaf is the JAX package's
`np.random.default_rng(seed).choice`, so both packages probe the same
entries of the same network.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models.serialization import _key_parts


def _f64(net, a):
    return torch.as_tensor(np.asarray(a, np.float64)).to(net.device)


def _mask(net, a):
    return None if a is None else tr.as_tensor(a).to(net.device)


def _widen(tree):
    """A float64 copy of a nested param dict."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.detach().to(torch.float64, copy=True)


def _leaves(net, params) -> List[Tuple[str, str, str]]:
    """(full key, layer key, path in the layer) of every param leaf, in
    the sorted key order of the JAX package's pytree flattening."""
    out = []
    for full, _ in _key_parts(params):
        k, path = full.split("/", 1)
        out.append((full, k, path))
    return out


def _node(tree, k, path):
    node = tree[k]
    *parents, name = path.split("/")
    for part in parents:
        node = node[part]
    return node, name


class _Probe:
    """The network's inference loss on `ds` (features and labels in
    float64, as the JAX package casts them) as a function of params, and
    float64 copies of the network's params to start from."""

    def __init__(self, net, ds):
        self.net = net
        self.x, self.y = _f64(net, ds.features), _f64(net, ds.labels)
        self.fm = _mask(net, ds.features_mask)
        self.lm = _mask(net, ds.labels_mask)
        self.params = _widen(net.params)

    def loss(self, params):
        s, _ = self.net._loss(params, self.x, self.y, self.fm, self.lm,
                              train=False)
        return s


def analytic_gradients(net, ds) -> Dict[str, np.ndarray]:
    """{"layer_i/name": float64 gradient in the interchange layout} of the
    network's inference loss on `ds` at float64 copies of its params, in
    the JAX package's leaf order."""
    probe = _Probe(net, ds)
    with dtypes.full_precision():
        return _analytic(probe)


def _analytic(probe) -> Dict[str, np.ndarray]:
    net = probe.net
    _, _, grads = tr.value_and_grad(
        lambda: (probe.loss(probe.params), None), probe.params)
    out = {}
    for full, k, path in _leaves(net, probe.params):
        g, name = _node(grads, k, path)
        out[full] = net.layer(k).to_interchange(path, g[name]).detach() \
            .cpu().numpy()
    return out


def check_gradients(
    net,
    ds,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-8,
    max_params_per_layer: int = 20,
    seed: int = 0,
    verbose: bool = False,
) -> bool:
    """Central-difference check on a MultiLayerNetwork, on its device.

    Up to `max_params_per_layer` scalar entries of each param leaf are
    probed (all of a smaller leaf): an entry passes when
    |analytic - numeric| / (|analytic| + |numeric|) <= max_rel_error or
    |analytic - numeric| <= min_abs_error. Returns whether every entry
    passed; `verbose` prints each failure and the largest relative error
    seen.
    """
    probe = _Probe(net, ds)
    with dtypes.full_precision(), torch.no_grad():
        with torch.enable_grad():
            analytic = _analytic(probe)
        npr = np.random.default_rng(seed)
        all_ok = True
        max_rel_seen = 0.0
        for li, (full, k, path) in enumerate(_leaves(net, probe.params)):
            layer = net.layer(k)
            node, name = _node(probe.params, k, path)
            live = node[name]
            pn = layer.to_interchange(path, live).detach().cpu().numpy()
            gn = analytic[full]
            n = pn.size
            idxs = (np.arange(n) if n <= max_params_per_layer
                    else npr.choice(n, max_params_per_layer, replace=False))

            def score_at(flat):
                t = torch.from_numpy(flat.reshape(pn.shape)).to(live.device)
                node[name] = layer.from_interchange(path, t)
                return float(probe.loss(probe.params))

            for idx in idxs:
                flat = pn.reshape(-1)
                orig = flat[idx]
                p_plus = flat.copy()
                p_plus[idx] = orig + epsilon
                p_minus = flat.copy()
                p_minus[idx] = orig - epsilon
                s_plus = score_at(p_plus)
                s_minus = score_at(p_minus)
                node[name] = live
                numeric = (s_plus - s_minus) / (2 * epsilon)
                a = gn.reshape(-1)[idx]
                abs_err = abs(a - numeric)
                denom = abs(a) + abs(numeric)
                rel = abs_err / denom if denom > 0 else 0.0
                max_rel_seen = max(max_rel_seen,
                                   rel if abs_err > min_abs_error else 0.0)
                ok = rel <= max_rel_error or abs_err <= min_abs_error
                if not ok:
                    all_ok = False
                    if verbose:
                        print(f"leaf {li} idx {idx}: analytic={a:.8g} "
                              f"numeric={numeric:.8g} rel={rel:.3g}")
        if verbose:
            print(f"gradient check max rel error: {max_rel_seen:.3g}")
        return all_ok
