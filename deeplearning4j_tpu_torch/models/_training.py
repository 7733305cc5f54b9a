"""The parts of a training step that MultiLayerNetwork and ComputationGraph
share: param trees, gradients over them, the l1/l2 penalty of one layer and
one layer's update, each as the JAX package's two runtimes compute it.

Params are nested dicts of tensors keyed by a layer key ("layer_3") or a
vertex name; `value_and_grad` turns them into leaves that record gradients
and hands back a gradient tree of the same structure. Under
`parallel.ParallelWrapper` (an `nn.shard` shard installed) it computes the
rank's share of the global batch's loss and hands back the global score
and gradients, summed over the ranks.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn import weightnoise as wn_mod
from deeplearning4j_tpu_torch.nn.regularization import apply_constraints


def as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    # torch.from_numpy cannot share a read-only buffer
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def to_device(tree, device):
    """A (nested) dict of tensors moved to `device`."""
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def slots_to_device(slots, device):
    """One layer's updater slots on `device`: a layer without params gets
    its step counter ("t") from an empty tree, which gives no device."""
    return to_device(slots, device) if isinstance(slots, dict) else slots


def clone_tree(tree):
    """A copy of nested dicts, lists and tuples of tensors, every tensor
    cloned (detached) on its device; other leaves kept."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def detach(tree):
    return {k: detach(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def detach_carry(carry):
    """A recurrent carry detached: a tensor (SimpleRnn's h), an (h, c)
    pair, or nested pairs (GravesBidirectionalLSTM's); None stays None."""
    if isinstance(carry, (tuple, list)):
        return type(carry)(detach_carry(c) for c in carry)
    return None if carry is None else carry.detach()


def flat_items(tree, prefix: str = ""):
    """(path, tensor) pairs of a nested param dict, paths joined by '/'
    ("attn/Wqkv"), in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from flat_items(v, path + "/")
        else:
            yield path, v


def value_and_grad(loss, params, frozen=frozenset()):
    """(score, aux, grads) of `loss() -> (score, aux)`, differentiated with
    respect to every tensor in `params` (a dict of nested param dicts)
    outside the keys in `frozen`, each made a leaf that records gradients
    first. The params under `frozen` record none, so the backward does
    not reach them (it ends at the first layer that trains), and their
    entries in `grads` are empty. `grads` mirrors `params`, zeros where
    the score does not depend on a param. With a data-parallel shard
    installed, `loss` runs with it active (`nn.shard`) and the score and
    gradients are summed over the ranks."""
    leaves = []
    for k, p in params.items():
        for path, t in flat_items(p):
            if k in frozen:
                t.requires_grad_(False)
                continue
            if not t.requires_grad:
                t.requires_grad_(True)
            leaves.append((k, path, t))
    with torch.enable_grad(), shard_mod.active() as shard:
        score, aux = loss()
        flat = torch.autograd.grad(score, [t for *_, t in leaves],
                                   allow_unused=True) if leaves else []
    flat = [torch.zeros_like(t) if g is None else g
            for (*_, t), g in zip(leaves, flat)]
    if shard is not None:
        score, flat = shard.reduce(score, flat)
    grads = {k: {} for k in params}
    for (k, path, t), g in zip(leaves, flat):
        node = grads[k]
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = g
    return score, aux, grads


def step_draws(draws):
    """A training step's draws: the network's, or as the installed shard
    takes them (a seq shard folds them by its index)."""
    shard = shard_mod.installed_shard()
    return draws if shard is None else shard.step_draws(draws)


def batch_rows(x) -> int:
    """The rows a step reports (`last_batch_size`): the global batch's
    before padding under the data-parallel wrapper, else x's."""
    shard = shard_mod.installed_shard()
    return shard.unpadded if shard is not None else int(x.shape[0])


def layer_updater(layer, default) -> upd_mod.Updater:
    """A layer's updater: its own, else the network default `default`, with
    the layer's learning-rate override applied to a copy. `layer` is None
    for a graph vertex that is not a layer."""
    own = layer.updater if layer is not None else None
    u = upd_mod.get(own if own is not None else default)
    if layer is not None and layer.learning_rate is not None:
        u = copy.copy(u)
        u.learning_rate = layer.learning_rate
    return u


def layer_forward(layer, state, train, p, x, mask, rng=None):
    """One layer's forward on `p` with its weight noise drawn from `rng`
    (a network's function for `parallel.layout.apply_layer`)."""
    return layer.apply(wn_mod.maybe_transform(layer, p, rng, train), x,
                       state=state, train=train, mask=mask, rng=rng)


def layer_scan(layer, train, p, x, carry, mask, rng=None):
    """A recurrent layer's scan from `carry`, as `layer_forward`."""
    return layer.scan(wn_mod.maybe_transform(layer, p, rng, train), x,
                      carry, mask=mask, train=train, rng=rng)


def layer_loss(layer, state, train, p, h, y, mask, rng=None):
    """An output layer's loss on `h`, as `layer_forward` (`rng` only for
    its weight noise)."""
    return layer.compute_loss(wn_mod.maybe_transform(layer, p, rng, train),
                              h, y, state=state, mask=mask)


def whole_params(net, key: str):
    """The whole params of `key` (gathered from the ranks' slices where
    the network is sharded; else its own dict)."""
    arr = net._shard_layout
    p = net.params[key]
    return p if arr is None else arr.whole(key, p)


def whole_slots(net, key, slots):
    """One layer's updater slots whole: a slot that mirrors the params is
    gathered as they are; scalars stay."""
    arr = net._shard_layout
    if arr is None or not isinstance(slots, dict):
        return slots
    return {k: arr.whole(key, v) if isinstance(v, dict) else v
            for k, v in slots.items()}


def layer_penalty(layer, p, defaults, biases: bool, total, key=None,
                  arr=None):
    """`total` plus one layer's l1/l2 penalty (BaseLayer.calcL1/calcL2):
    l1 * sum|w| + 0.5 * l2 * sum w^2 over its `regularizable` params and,
    with `biases`, the bias terms over its params named "b*" (the JAX
    MultiLayerNetwork counts them, its ComputationGraph does not). Under
    the data-parallel wrapper only rank 0 adds it, so the ranks' summed
    scores and gradients count it once; on a sharded network (`arr`, its
    arrangement; `key`, the layer's params key) each slice counts once."""
    shard = shard_mod.current()
    if shard is not None and not shard.counts_penalty():
        return total
    terms = {}

    def add(path, v, l1, l2):
        t = terms.get(path)
        if l1:
            t = l1 * v.abs().sum() if t is None else t + l1 * v.abs().sum()
        if l2:
            t2 = 0.5 * l2 * (v * v).sum()
            t = t2 if t is None else t + t2
        if t is not None:
            terms[path] = t

    l1 = layer.l1 if layer.l1 is not None else defaults.l1
    l2 = layer.l2 if layer.l2 is not None else defaults.l2
    if l1 or l2:
        for path, v in flat_items(layer.regularizable(p)):
            add(path, v, l1, l2)
    if biases:
        l1b = layer.l1_bias if layer.l1_bias is not None else defaults.l1_bias
        l2b = layer.l2_bias if layer.l2_bias is not None else defaults.l2_bias
        if l1b or l2b:
            for name, v in p.items():
                if name.startswith("b"):
                    add(name, v, l1b, l2b)
    if not terms:
        return total
    if arr is None:
        for t in terms.values():
            total = total + t
        return total
    return total + arr.global_sum(key, terms)


def update_layer(layer, defaults, updater, params, grads, slots,
                 iteration: int, key=None, arr=None):
    """One layer's update, in place under no_grad: gradient normalization
    (the layer's, else the network default), the updater rule at the
    scheduled learning rate, params -= step, then the layer's constraints.
    `layer` is None for a graph vertex that is not a layer (the defaults
    apply). On a sharded network (`arr`, its arrangement; `key`, the
    layer's params key) the norms span every slice and the constraints act
    on the whole params. Returns the new updater slots."""
    d = defaults

    def pick(field):
        own = getattr(layer, field) if layer is not None else None
        return own if own is not None else getattr(d, field)

    norm = None
    if arr is not None:
        def norm(tree):
            sq = {path: (g * g).sum()
                  for path, g in flat_items(tree)}
            return arr.global_sum(key, sq).sqrt()
    g = upd_mod.normalize_gradients(
        grads, pick("gradient_normalization"),
        pick("gradient_normalization_threshold"), norm=norm)
    lr = (d.lr_schedule(updater.learning_rate, iteration) if d.lr_schedule
          else updater.learning_rate)
    steps, slots = updater.apply(g, slots, lr)
    upd_mod.tree_map(lambda p, s: p.sub_(s), params, steps)
    if layer is not None and layer.constraints:
        whole = params if arr is None else arr.whole(key, params)
        fixed = apply_constraints(whole, layer.constraints)
        if arr is not None:
            fixed = arr.scatter(key, fixed)
        upd_mod.tree_map(lambda p, c: p.copy_(c), params, fixed)
    return slots
