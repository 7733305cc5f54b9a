"""The solver family (ConvexOptimizer): full-batch line-search optimizers
(counterpart of deeplearning4j_tpu/optimize/solvers.py).

Reference surface: optimize/Solver.java:43-50 (a ConvexOptimizer from
conf.optimizationAlgo), solvers/BaseOptimizer.java:395 (gradientAndScore,
the step loop, the terminations), StochasticGradientDescent.java:58-100,
LineGradientDescent.java, ConjugateGradient.java (Polak-Ribiere+, gamma =
max(., 0)), LBFGS.java (two-loop recursion), BackTrackLineSearch.java
(Armijo backtracking, ALF 1e-4, stepMax 100), stepfunctions/*.java and
terminations/{Eps,Norm2}Termination.java, ZeroDirection.java.

The param tree is ravelled into ONE flat float tensor on the params'
device, in `jax.flatten_util.ravel_pytree`'s order (the keys of every dict
sorted, so "layer_10" comes before "layer_2"), so that it equals the JAX
package's vector element by element where the layouts agree. An
iteration is the JAX package's program run eagerly: the score and
gradient at v, the direction, the backtracking line search, the step, and
the score and gradient at the new point (the iteration's result, which
CG and LBFGS keep as their next gradient). The line search is a Python
loop with one host read per trial (inside XLA it has none);
`last_trials` counts the last iteration's trials beside its `last_alpha`
and `last_score0`. Trials compute the score under `torch.no_grad()`. The
terminations run on the host between iterations, the pre-step score
standing in for the previous cost on the first one, and the solver state
(CG's last gradient and direction, LBFGS's (s, y) history) lives on the
optimizer across `optimize` calls.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

ALF = 1e-4  # Armijo sufficient-decrease constant (BackTrackLineSearch.ALF)
STEP_MAX = 100.0  # largest initial step norm (BackTrackLineSearch.stepMax)

_F32 = np.float32


# ---------------------------------------------------------------------------
# flat vectors in ravel_pytree's order
# ---------------------------------------------------------------------------
def tree_leaves_sorted(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of nested dicts, every dict's keys sorted (the
    order of jax.tree_util and so of ravel_pytree)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend((f"{k}/{p}", t) for p, t in tree_leaves_sorted(v))
        else:
            out.append((k, v))
    return out


def _skeleton(tree):
    """`tree`'s nested dicts with None in place of every leaf (empty dicts
    kept: a layer without params keeps its entry)."""
    return {k: _skeleton(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _fill(skeleton, leaves):
    return {k: _fill(skeleton[k], leaves) if isinstance(skeleton[k], dict)
            else next(leaves) for k in sorted(skeleton)}


def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """(flat, unravel): the leaves of `tree` concatenated in sorted-key
    order as one contiguous tensor, and a function turning a flat tensor
    of that length back into a tree of the same structure (empty dicts
    included) whose leaves are views of it (detached, so each can become a
    leaf of a gradient). `unravel.paths` lists the leaves' '/'-joined
    paths in that order."""
    items = tree_leaves_sorted(tree)
    shapes = [(t.shape, t.numel()) for _, t in items]
    skeleton = _skeleton(tree)
    if items:
        flat = torch.cat([t.detach().reshape(-1) for _, t in items])
    else:
        flat = torch.zeros(0)

    def unravel(v: torch.Tensor):
        views, off = [], 0
        for shape, n in shapes:
            views.append(v[off:off + n].view(shape).detach())
            off += n
        return _fill(skeleton, iter(views))

    unravel.paths = [p for p, _ in items]
    return flat, unravel


def ravel_like(tree, paths: Sequence[str]) -> torch.Tensor:
    """`tree`'s leaves at `paths` ('/'-joined, as `unravel.paths` lists
    them) flattened into one tensor in that order."""
    leaves = []
    for path in paths:
        node = tree
        for part in path.split("/"):
            node = node[part]
        leaves.append(node.reshape(-1))
    return torch.cat(leaves) if leaves else torch.zeros(0)


# ---------------------------------------------------------------------------
# step functions (stepfunctions/*.java)
# ---------------------------------------------------------------------------
class StepFunction:
    """params' = step(params, direction, alpha) on flat vectors."""

    name = "step"

    def __call__(self, params, direction, alpha):
        raise NotImplementedError


class DefaultStepFunction(StepFunction):
    name = "default"

    def __call__(self, params, direction, alpha):
        return params + alpha * direction


class NegativeDefaultStepFunction(StepFunction):
    name = "negative_default"

    def __call__(self, params, direction, alpha):
        return params - alpha * direction


class GradientStepFunction(StepFunction):
    name = "gradient"

    def __call__(self, params, direction, alpha):
        return params + direction


class NegativeGradientStepFunction(StepFunction):
    name = "negative_gradient"

    def __call__(self, params, direction, alpha):
        return params - direction


# ---------------------------------------------------------------------------
# termination conditions (terminations/*.java), on the host between
# iterations
# ---------------------------------------------------------------------------
class TerminationCondition:
    def terminate(self, cost_old: float, cost_new: float, extra: dict) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """Relative and absolute improvement tolerance (EpsTermination.java)."""

    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-10):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost_old, cost_new, extra):
        denom = abs(cost_old) + abs(cost_new) + self.tolerance
        return 2.0 * abs(cost_new - cost_old) <= self.eps * denom


class Norm2Termination(TerminationCondition):
    """The gradient's L2 norm below a tolerance (Norm2Termination.java)."""

    def __init__(self, gradient_tolerance: float = 1e-6):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, cost_old, cost_new, extra):
        return extra.get("grad_norm", math.inf) < self.gradient_tolerance


class ZeroDirection(TerminationCondition):
    """The search direction vanished (ZeroDirection.java)."""

    def terminate(self, cost_old, cost_new, extra):
        return extra.get("dir_norm", math.inf) == 0.0


DEFAULT_TERMINATIONS: Tuple[TerminationCondition, ...] = (
    ZeroDirection(),
    EpsTermination(),
)


# ---------------------------------------------------------------------------
# backtracking line search (BackTrackLineSearch.java)
# ---------------------------------------------------------------------------
def backtrack_line_search(score_fn, x, direction, score0, slope,
                          max_iterations: int, step_max: float = STEP_MAX,
                          rel_tol_x: float = 1e-7):
    """Armijo backtracking along `direction` (a descent direction: slope <
    0). Returns (alpha, trials): the accepted step size (0.0 when no trial
    met Armijo within `max_iterations`, or when the slope is not negative:
    the reference then takes no step) and the trials evaluated.

    `score_fn(v)` gives the score at v as a 0-d tensor; `score0` and
    `slope` are 0-d tensors (or floats). An overlong direction is scaled
    down to `step_max` (BackTrackLineSearch.java:195-197) and the search
    stops once alpha falls below the least step that still moves x
    (`rel_tol_x`, :179). The host arithmetic is float32, as the JAX
    package's on the device."""
    dir_norm = torch.linalg.vector_norm(direction)
    scale = torch.where(dir_norm > step_max, step_max / (dir_norm + 1e-30),
                        torch.ones_like(dir_norm))
    d = direction * scale
    step_min = rel_tol_x / (d.abs().max() / (x.abs().max() + 1.0) + 1e-30) \
        if d.numel() else torch.zeros_like(dir_norm)
    host = torch.stack([
        torch.as_tensor(score0, dtype=d.dtype, device=d.device).reshape(()),
        (torch.as_tensor(slope, dtype=d.dtype, device=d.device) * scale)
        .reshape(()),
        torch.as_tensor(step_min, dtype=d.dtype).reshape(()),
        scale.reshape(())]).float().cpu().numpy()
    s0, slope_s, smin, scale_h = (_F32(v) for v in host)
    alpha, accepted, trials = _F32(1.0), _F32(0.0), 0
    while trials < max_iterations:
        new_score = _F32(float(score_fn(x + float(alpha) * d)))
        trials += 1
        ok = new_score <= s0 + _F32(ALF) * alpha * slope_s
        if ok:
            accepted = alpha
            break
        if alpha < smin:
            break
        alpha = alpha * _F32(0.5)
    if not slope_s < 0.0:
        return 0.0, trials
    return float(accepted * scale_h), trials


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
class ConvexOptimizer:
    """Base of the solver family (BaseOptimizer.java).

    `value_and_grad(params_tree, *args) -> (score, grads_tree)` gives a 0-d
    score tensor and a gradient tree of the params' structure; the solver
    minimizes the score. `score_fn(params_tree, *args) -> score`, when
    given, is what the line search's trials call (under no_grad; default:
    `value_and_grad`'s score). Extra *args pass through to every
    evaluation of an `optimize` call."""

    name = "base"
    _score_is_poststep = True  # line-search solvers evaluate after the step

    def __init__(self, value_and_grad: Callable,
                 step_function: Optional[StepFunction] = None,
                 termination_conditions: Sequence[TerminationCondition] = DEFAULT_TERMINATIONS,
                 learning_rate: float = 1.0,
                 max_line_search_iterations: int = 5,
                 listeners: Sequence = (),
                 score_fn: Optional[Callable] = None):
        self.value_and_grad = value_and_grad
        self.score_fn = score_fn
        self.step_function = step_function or NegativeDefaultStepFunction()
        self.termination_conditions = list(termination_conditions)
        self.learning_rate = learning_rate
        self.max_line_search_iterations = max_line_search_iterations
        self.listeners = list(listeners)
        self.iteration = 0
        self.score = None
        # the last iteration's line-search trials, alpha and pre-step score
        self.last_trials = 0
        self.last_alpha = None
        self.last_score0 = None
        self._solver_state = None

    # -- solver-specific: (direction, new solver state) on flat vectors
    def _direction(self, grad, solver_state):
        raise NotImplementedError

    def _init_solver_state(self, n: int, like: torch.Tensor):
        return ()

    def _flat_vag(self, unravel, v, args):
        score, grads = self.value_and_grad(unravel(v), *args)
        return score.detach(), ravel_like(grads, unravel.paths).detach()

    def _flat_score(self, unravel, args):
        def score_only(vv):
            with torch.no_grad():
                if self.score_fn is not None:
                    return self.score_fn(unravel(vv), *args).detach()
                return self.value_and_grad(unravel(vv), *args)[0].detach()
        return score_only

    def _one_iter(self, unravel, v, solver_state, args):
        score0, g = self._flat_vag(unravel, v, args)
        direction, solver_state = self._direction(g, solver_state)
        # the slope along the APPLIED step: the step function may negate
        applied = self.step_function(v, direction, 1.0) - v
        slope = torch.dot(applied, g)
        alpha, trials = backtrack_line_search(
            self._flat_score(unravel, args), v, applied, score0, slope,
            self.max_line_search_iterations)
        new_v = v + alpha * applied
        new_score, new_g = self._flat_vag(unravel, new_v, args)
        self.last_trials = trials
        return new_v, new_score, new_g, solver_state, {
            "grad_norm": torch.linalg.vector_norm(new_g),
            "dir_norm": torch.linalg.vector_norm(direction),
            "alpha": alpha,
            "score0": score0,
        }

    def optimize(self, params, *args, iterations: int = 1):
        """Up to `iterations` solver iterations from `params` (a tree of
        tensors; BaseOptimizer.optimize). Returns (new_params, score):
        the new params as a tree of views of one flat tensor, and the
        last iteration's (post-step) score as a float."""
        v, unravel = ravel(params)
        solver_state = self._solver_state
        if solver_state is None:
            solver_state = self._init_solver_state(v.numel(), v)
        score_old = None
        score = None
        for _ in range(iterations):
            v, score_t, g, solver_state, extra = self._one_iter(
                unravel, v, solver_state, args)
            names = [k for k, x in extra.items() if torch.is_tensor(x)]
            host = torch.stack([score_t.float().reshape(())] + [
                extra[k].float().reshape(()) for k in names]).cpu().tolist()
            score = host[0]
            host_extra = {k: float(x) for k, x in extra.items()}
            host_extra.update(zip(names, host[1:]))
            self.last_alpha = host_extra["alpha"]
            self.last_score0 = host_extra["score0"]
            self.iteration += 1
            self.score = score
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration, score)
            # the pre-step score stands in for the previous cost on the
            # first iteration, so the terminations can fire with
            # iterations=1. SGD reports the PRE-step score, so there the
            # comparison waits for a real previous iteration
            if score_old is not None or self._score_is_poststep:
                cost_old = (score_old if score_old is not None
                            else host_extra["score0"])
                if any(t.terminate(cost_old, score, host_extra)
                       for t in self.termination_conditions):
                    break
            score_old = score
        self._solver_state = solver_state
        return unravel(v), score


class StochasticGradientDescent(ConvexOptimizer):
    """A plain step along -lr * g, no line search
    (StochasticGradientDescent.java:58-100)."""

    name = "stochastic_gradient_descent"
    _score_is_poststep = False

    def _one_iter(self, unravel, v, solver_state, args):
        score, g = self._flat_vag(unravel, v, args)
        new_v = self.step_function(v, g, self.learning_rate)
        self.last_trials = 0
        norm = torch.linalg.vector_norm(g)
        return new_v, score, g, solver_state, {
            "grad_norm": norm, "dir_norm": norm,
            "alpha": float(self.learning_rate), "score0": score}


class LineGradientDescent(ConvexOptimizer):
    """Steepest descent with a line search (LineGradientDescent.java)."""

    name = "line_gradient_descent"

    def _direction(self, grad, solver_state):
        return grad, solver_state  # the step function negates


class ConjugateGradient(ConvexOptimizer):
    """Polak-Ribiere+ nonlinear CG (ConjugateGradient.java: gamma =
    max(((g_new - g_old) . g_new) / (g_old . g_old), 0); gamma = 0 is
    steepest descent, so the direction is one of descent). A rejected step
    (alpha 0) restarts from steepest descent."""

    name = "conjugate_gradient"

    def _init_solver_state(self, n: int, like: torch.Tensor):
        # [g_last, dir_last, first iteration]
        return [torch.zeros_like(like), torch.zeros_like(like), True]

    def _direction(self, grad, solver_state):
        g_last, dir_last, first = solver_state
        if first:
            direction = grad + 0.0 * dir_last
        else:
            dgg = torch.dot(grad - g_last, grad)
            gg = torch.dot(g_last, g_last)
            gamma = torch.clamp_min(dgg / (gg + 1e-30), 0.0)
            direction = grad + gamma * dir_last
        return direction, [grad, direction, False]

    def _one_iter(self, unravel, v, st, args):
        new_v, score, new_g, st, extra = super()._one_iter(unravel, v, st,
                                                           args)
        if extra["alpha"] == 0.0:
            st[2] = True
        return new_v, score, new_g, st, extra


class LBFGS(ConvexOptimizer):
    """L-BFGS, two-loop recursion over a circular (s, y) history of
    `memory` pairs (LBFGS.java; 4 is the reference's default). A pair is
    kept only when s . y > 1e-10."""

    name = "lbfgs"

    def __init__(self, *a, memory: int = 4, **kw):
        super().__init__(*a, **kw)
        self.memory = memory

    def _init_solver_state(self, n: int, like: torch.Tensor):
        m = self.memory
        z = like.new_zeros
        return {"s": z((m, n)), "y": z((m, n)), "rho": z(m),
                "count": 0,  # iterations seen (g_last valid after one)
                "hist": torch.zeros((), dtype=torch.int64,
                                    device=like.device),  # pairs kept
                "g_last": z(n)}

    def _direction(self, grad, st):
        m = self.memory
        s, y, rho = st["s"], st["y"], st["rho"]
        q = grad
        alphas = [None] * m
        for i in range(m):
            idx = m - 1 - i
            a = rho[idx] * torch.dot(s[idx], q)
            q = q - a * y[idx]
            alphas[idx] = a
        # the initial Hessian scale s.y / y.y of the newest pair; identity
        # until a pair exists (empty slots have rho 0 and add nothing)
        sy = torch.dot(s[-1], y[-1])
        yy = torch.dot(y[-1], y[-1])
        gamma = torch.where(st["hist"] > 0, sy / (yy + 1e-30),
                            torch.ones_like(sy))
        r = gamma * q
        for i in range(m):
            b = rho[i] * torch.dot(y[i], r)
            r = r + s[i] * (alphas[i] - b)
        return r, st

    def _one_iter(self, unravel, v, st, args):
        new_v, score, new_g, st, extra = super()._one_iter(unravel, v, st,
                                                           args)
        s_vec = new_v - v
        y_vec = new_g - st["g_last"]
        sy = torch.dot(s_vec, y_vec)
        valid = (sy > 1e-10) if st["count"] > 0 else torch.zeros_like(
            sy, dtype=torch.bool)

        def push(hist, new):
            return torch.where(valid, torch.cat([hist[1:], new[None]]), hist)

        st = dict(st)
        st["s"] = push(st["s"], s_vec)
        st["y"] = push(st["y"], y_vec)
        st["rho"] = push(st["rho"], 1.0 / (sy + 1e-30))
        st["g_last"] = new_g
        st["count"] += 1
        st["hist"] = st["hist"] + valid.to(st["hist"].dtype)
        return new_v, score, new_g, st, extra


# ---------------------------------------------------------------------------
# the Solver facade (optimize/Solver.java:43-50)
# ---------------------------------------------------------------------------
_OPTIMIZERS = {
    "stochastic_gradient_descent": StochasticGradientDescent,
    "sgd": StochasticGradientDescent,
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """Builds the ConvexOptimizer named by conf.optimization_algo and
    drives it (Solver.Builder)."""

    def __init__(self, optimization_algo: str, value_and_grad: Callable,
                 learning_rate: float = 0.1,
                 max_line_search_iterations: int = 5,
                 termination_conditions: Sequence[TerminationCondition] = DEFAULT_TERMINATIONS,
                 listeners: Sequence = (),
                 score_fn: Optional[Callable] = None):
        cls = _OPTIMIZERS.get(optimization_algo)
        if cls is None:
            raise ValueError(
                f"unknown optimization_algo {optimization_algo!r}; "
                f"one of {sorted(_OPTIMIZERS)}")
        self.optimizer: ConvexOptimizer = cls(
            value_and_grad,
            learning_rate=learning_rate,
            max_line_search_iterations=max_line_search_iterations,
            termination_conditions=termination_conditions,
            listeners=listeners, score_fn=score_fn)

    def optimize(self, params, *args, iterations: int = 1):
        return self.optimizer.optimize(params, *args, iterations=iterations)
