"""Updaters (counterpart of deeplearning4j_tpu/nn/updaters.py): the 8 rules
of DL4J's `Updater` enum plus NoOp, with DL4J default hyperparameters, and
gradient normalization/clipping.

Each rule is functional, as in the JAX package: `init_state(params)` gives
the slots, `apply(grads, state, lr) -> (steps, new_state)` where `steps` is
what gets SUBTRACTED from the params. Params, grads, steps and slots are
nested dicts of tensors mirroring one layer's params; slot names are the
JAX package's ("m", "v", "t", ...), so `interop.opt_state_from_jax` carries
them across. Step counters ("t") are int32 0-d tensors on the params'
device, so a step never waits on the host.

Adam is DL4J's AdamUpdater, not torch.optim.Adam: alpha = lr *
sqrt(1 - beta2^t) / (1 - beta1^t) and epsilon is added to sqrt(v) outside
the bias correction.

GradientNormalization (nn/conf/GradientNormalization.java) runs before the
rule, per layer: `normalize_gradients`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import schedules as sched_mod

Tree = Any


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts of tensors (the same structure in
    `rest`), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _zeros_like_tree(params):
    return tree_map(torch.zeros_like, params)


def _step_counter(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves and isinstance(
        leaves[0], torch.Tensor) else None
    return torch.zeros((), dtype=torch.int32, device=device)


class Updater:
    """Base updater: `init_state(params)` and `apply(grads, state, lr) ->
    (steps, new_state)`."""

    name: str = "base"

    def init_state(self, params: Tree) -> Tree:
        return None

    def apply(self, grads: Tree, state: Tree, lr) -> Tuple[Tree, Tree]:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, sched_mod.Schedule):
                d[k] = v.to_json()
            else:
                d[k] = v
        return d


@dataclass
class Sgd(Updater):
    learning_rate: float = 1e-1
    name: str = field(default="sgd", repr=False)

    def init_state(self, params):
        return ()

    def apply(self, grads, state, lr):
        return tree_map(lambda g: lr * g, grads), state


@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="adam", repr=False)

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params),
                "t": _step_counter(params)}

    def apply(self, grads, state, lr):
        t = state["t"] + 1
        tf = t.float()
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        # DL4J AdamUpdater: alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)
        alpha = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        steps = tree_map(
            lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + self.epsilon), m, v)
        return steps, {"m": m, "v": v, "t": t}


@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="adamax", repr=False)

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "u": _zeros_like_tree(params),
                "t": _step_counter(params)}

    def apply(self, grads, state, lr):
        t = state["t"] + 1
        b1 = self.beta1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(self.beta2 * u_, g.abs()),
                     state["u"], grads)
        alpha = lr / (1 - b1 ** t.float())
        steps = tree_map(lambda m_, u_: alpha * m_ / (u_ + self.epsilon), m, u)
        return steps, {"m": m, "u": u, "t": t}


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0  # AdaDelta ignores lr in DL4J; kept for API parity
    name: str = field(default="adadelta", repr=False)

    def init_state(self, params):
        return {"msg": _zeros_like_tree(params),
                "msdx": _zeros_like_tree(params)}

    def apply(self, grads, state, lr):
        rho, eps = self.rho, self.epsilon
        msg = tree_map(lambda a, g: rho * a + (1 - rho) * g * g, state["msg"],
                       grads)
        steps = tree_map(lambda a, m2, g: torch.sqrt((a + eps) / (m2 + eps))
                         * g, state["msdx"], msg, grads)
        msdx = tree_map(lambda a, dx: rho * a + (1 - rho) * dx * dx,
                        state["msdx"], steps)
        return steps, {"msg": msg, "msdx": msdx}


@dataclass
class Nesterovs(Updater):
    learning_rate: float = 1e-1
    momentum: float = 0.9
    name: str = field(default="nesterovs", repr=False)

    def init_state(self, params):
        return {"v": _zeros_like_tree(params)}

    def apply(self, grads, state, lr):
        mu = self.momentum
        v = tree_map(lambda v_, g: mu * v_ - lr * g, state["v"], grads)
        # Nesterov "lookahead" step; params -= step
        steps = tree_map(lambda v2, g: -(mu * v2 - lr * g), v, grads)
        return steps, {"v": v}


@dataclass
class Nadam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="nadam", repr=False)

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params),
                "t": _step_counter(params)}

    def apply(self, grads, state, lr):
        t = state["t"] + 1
        tf = t.float()
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        one_minus_b1t = 1 - b1 ** tf
        one_minus_b2t = 1 - b2 ** tf

        def step(m_, v_, g):
            m_hat = m_ / one_minus_b1t
            v_hat = v_ / one_minus_b2t
            m_bar = (1 - b1) * g / one_minus_b1t + b1 * m_hat
            return lr * m_bar / (torch.sqrt(v_hat) + eps)

        return tree_map(step, m, v, grads), {"m": m, "v": v, "t": t}


@dataclass
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6
    name: str = field(default="adagrad", repr=False)

    def init_state(self, params):
        return {"h": _zeros_like_tree(params)}

    def apply(self, grads, state, lr):
        h = tree_map(lambda h_, g: h_ + g * g, state["h"], grads)
        steps = tree_map(
            lambda h_, g: lr * g / (torch.sqrt(h_) + self.epsilon), h, grads)
        return steps, {"h": h}


@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    name: str = field(default="rmsprop", repr=False)

    def init_state(self, params):
        return {"g2": _zeros_like_tree(params)}

    def apply(self, grads, state, lr):
        d = self.rms_decay
        g2 = tree_map(lambda a, g: d * a + (1 - d) * g * g, state["g2"],
                      grads)
        steps = tree_map(lambda a, g: lr * g / torch.sqrt(a + self.epsilon),
                         g2, grads)
        return steps, {"g2": g2}


@dataclass
class NoOp(Updater):
    """DL4J Updater.NONE — gradient applied raw (lr=1) or frozen layers."""

    learning_rate: float = 1.0
    name: str = field(default="none", repr=False)

    def init_state(self, params):
        return ()

    def apply(self, grads, state, lr):
        return grads, state


_TYPES = {
    c.__name__: c
    for c in [Sgd, Adam, AdaMax, AdaDelta, Nesterovs, Nadam, AdaGrad, RmsProp, NoOp]
}
_BY_NAME = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adadelta": AdaDelta,
    "nesterovs": Nesterovs, "nadam": Nadam, "adagrad": AdaGrad,
    "rmsprop": RmsProp, "none": NoOp, "noop": NoOp,
}


def get(u) -> Updater:
    if isinstance(u, Updater):
        return u
    if isinstance(u, str):
        key = u.lower()
        if key not in _BY_NAME:
            raise ValueError(f"Unknown updater '{u}'. Known: {sorted(_BY_NAME)}")
        return _BY_NAME[key]()
    raise TypeError(f"Cannot resolve updater from {u!r}")


def from_json(d: dict) -> Updater:
    d = dict(d)
    t = d.pop("type")
    d.pop("name", None)
    return _TYPES[t](**d)


# ---------------------------------------------------------------------------
# Gradient normalization (applied before the update rule)
# ---------------------------------------------------------------------------


def _total_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum((leaf * leaf).sum() for leaf in leaves))


def normalize_gradients(grads: Tree, mode: Optional[str],
                        threshold: float = 1.0, norm=None) -> Tree:
    """DL4J GradientNormalization over ONE layer's gradient tree: per-layer
    modes act on all its leaves together, per-param-type modes leaf by
    leaf. `norm(tree)` is the L2 norm of a subtree (default: of its
    leaves; a sharded network passes one that spans every rank's slice)."""
    if not mode or mode == "None":
        return grads
    if norm is None:
        def norm(tree):
            return _total_norm(tree_leaves(tree))

    def per_param(fn):
        def walk(tree, prefix=""):
            return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else fn(v, norm({f"{prefix}{k}": v}))
                    for k, v in tree.items()}

        return walk(grads)

    if mode == "RenormalizeL2PerLayer":
        scale = 1.0 / norm(grads).clamp_min(1e-12)
        return tree_map(lambda g: g * scale, grads)
    if mode == "RenormalizeL2PerParamType":
        return per_param(lambda g, n: g / n.clamp_min(1e-12))
    if mode == "ClipElementWiseAbsoluteValue":
        return tree_map(lambda g: g.clamp(-threshold, threshold), grads)

    def clip_scale(n):
        return torch.where(n > threshold, threshold / n.clamp_min(1e-12),
                           torch.ones_like(n))

    if mode == "ClipL2PerLayer":
        scale = clip_scale(norm(grads))
        return tree_map(lambda g: g * scale, grads)
    if mode == "ClipL2PerParamType":
        return per_param(lambda g, n: g * clip_scale(n))
    raise ValueError(f"Unknown gradient normalization '{mode}'")
