"""ShardedTransformerLM: a decoder-only LM trained over dp x tp x sp x pp x
ep in one step (counterpart of deeplearning4j_tpu/parallel/transformer.py).

One process per rank of a grid (`parallel.mesh.build_mesh`):

  dp -- rows of the batch over "data"; gradients summed over it;
  tp -- Megatron over "model": each rank holds its heads' columns of Wqkv
        [D, 3, H, dh] and bqkv, its heads' rows of Wo and its columns of
        W1 / rows of W2; `AxisGroup.copy` (f: identity forward, the
        cotangent summed backward) enters each branch, `AxisGroup.reduce`
        (g: the sum forward, identity backward) leaves it;
  sp -- time over "seq": every block runs `parallel.ring`'s ring attention
        on its local heads, even at seq = 1 (so the flash kernels, rows
        2-4, run on every path), the position table indexed at the shard's
        global offset;
  pp -- the stacked blocks [n_layers, ...] split on the layer axis over
        "pipe"; a GPipe schedule of M = `microbatches` (else pp)
        microbatches, each stage taking its input from the previous stage
        and sending its output on (`AxisGroup.send` / `recv`), the backward
        the reverse schedule; logits and the loss on the last stage;
  ep -- the Switch top-1 MoE FFN's experts over "expert": each rank runs
        its local experts e0 = rank * el .. e0 + el - 1 on the tokens routed
        to them, the combine is a g over the axis, the replicated router's
        gate applied after the combine so its gradient is whole on every
        rank.

Gradient correctness, as in the JAX package: the loss normalizer (the
weights' total over data x seq) is taken outside the gradient, each rank's
loss is its share of the global weighted mean, and the gradients are
summed over (data, seq), plus pipe for the leaves the pipe axis does not
split (`_grad_reduce_axes`). The updater (the port's `nn.updaters`, the
JAX suite's rules) runs on each rank's slices.

Params are held as the JAX package lays them out (`param_specs`): "embed"
[V, D], "pos" [max_len, D], "blocks" stacked per leaf, "lnf"; each rank
keeps its slice of every leaf. `save` gathers them whole and writes the
JAX package's zip (configuration.json with transformer_config and
updater, coefficients.npz, updaterState.npz, metadata.json with
model_type "ShardedTransformerLM"); `restore` reads either package's onto
any factorization. The logits' product with embed^T, the log-softmax and
the MoE's products are plain `torch.matmul`, as the JAX package computes
them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import json
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.parallel import layout as layout_mod
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel import ring

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclass
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    ffn_mult: int = 4
    max_len: int = 2048
    n_experts: int = 0           # 0 = dense FFN; >0 = Switch top-1 MoE
    expert_ffn_mult: Optional[int] = None  # default: ffn_mult
    microbatches: Optional[int] = None     # pipeline depth (default: pp)
    #: per-block activation-checkpoint policy: 'none' | 'dots_saveable' |
    #: 'full' | 'offload' (parallel/layout.py); True = 'full', False =
    #: 'none'
    remat: Any = True
    dtype: Any = torch.float32   # params and activations
    #: each ring hop's K/V chunk on the online route
    #: (parallel/ring.py _hop_update); the kernel route tiles itself
    attention_block: Optional[int] = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _ln(p, x, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _unflat(items):
    out = {}
    for path, v in items:
        node = out
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = v
    return out


class ShardedTransformerLM:
    """Decoder-only LM with tied embeddings, pre-LN blocks and causal ring
    attention over a grid's axes (size-1 axes are fine, so the same code
    runs in one process and on many ranks). Every rank runs the same
    calls; `device` None is the card."""

    def __init__(self, config: TransformerConfig, mesh: mesh_mod.Grid,
                 updater: Optional[upd_mod.Updater] = None,
                 data_axis: str = "data", model_axis: str = "model",
                 seq_axis: str = "seq", pipe_axis: str = "pipe",
                 expert_axis: str = "expert", device=None):
        c = config
        shape = mesh.shape
        if c.d_model % c.n_heads:
            raise ValueError("n_heads must divide d_model")
        tp = shape[model_axis]
        if c.n_heads % tp:
            raise ValueError(f"tp={tp} must divide n_heads={c.n_heads}")
        if (c.ffn_mult * c.d_model) % tp:
            raise ValueError("tp must divide ffn hidden dim")
        pp = shape[pipe_axis]
        if c.n_layers % pp:
            raise ValueError(f"pp={pp} must divide n_layers={c.n_layers}")
        ep = shape[expert_axis]
        if ep > 1 and c.n_experts == 0:
            raise ValueError("expert axis > 1 requires n_experts > 0")
        if c.n_experts and c.n_experts % ep:
            raise ValueError(f"ep={ep} must divide n_experts={c.n_experts}")
        self.config = c
        self.mesh = mesh
        self.device = device_mod.resolve(device)
        self.updater = updater or upd_mod.Adam(learning_rate=3e-4)
        self.ax_d, self.ax_m, self.ax_s = data_axis, model_axis, seq_axis
        self.ax_p, self.ax_e = pipe_axis, expert_axis
        self.params: Optional[Dict] = None
        self.opt_state: Optional[Dict] = None
        self.iteration = 0
        self.score_ = float("nan")

    def _axis(self, name: str) -> shard_mod.AxisGroup:
        return self.mesh.axis(name)

    @property
    def _pp(self) -> int:
        return self.mesh.shape[self.ax_p]

    # ---------------- params ----------------
    def init(self, seed: int = 0) -> "ShardedTransformerLM":
        """Whole params from `seed` (the same on every rank), then each
        rank keeps its slices; a fresh updater state."""
        whole = self._init_params(seed)
        self.load_params(whole)
        return self

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        """{path: whole shape} of the params (the JAX layout)."""
        c = self.config
        D, H, dh, L = c.d_model, c.n_heads, c.head_dim, c.n_layers
        F = c.ffn_mult * D
        E = c.n_experts
        Fe = (c.expert_ffn_mult or c.ffn_mult) * D
        blk = {"ln1/g": (D,), "ln1/b": (D,), "Wqkv": (D, 3, H, dh),
               "bqkv": (3, H, dh), "Wo": (H, dh, D), "bo": (D,),
               "ln2/g": (D,), "ln2/b": (D,)}
        if E:
            blk.update({"Wr": (D, E), "We1": (E, D, Fe), "be1": (E, Fe),
                        "We2": (E, Fe, D), "be2": (E, D)})
        else:
            blk.update({"W1": (D, F), "b1": (F,), "W2": (F, D),
                        "b2": (D,)})
        out = {"embed": (c.vocab, D), "pos": (c.max_len, D),
               "lnf/g": (D,), "lnf/b": (D,)}
        out.update({f"blocks/{k}": (L,) + s for k, s in blk.items()})
        return out

    def _init_params(self, seed: int) -> Dict:
        """Whole params: normal weights (the JAX package's scales), unit
        norm gains, zero biases, drawn from a torch generator seeded with
        `seed` in a fixed order."""
        c = self.config
        D, H, dh = c.d_model, c.n_heads, c.head_dim
        Fe = (c.expert_ffn_mult or c.ffn_mult) * D
        F = c.ffn_mult * D
        std = {"embed": 0.02, "pos": 0.02, "blocks/Wqkv": D ** -0.5,
               "blocks/Wo": (H * dh) ** -0.5, "blocks/Wr": D ** -0.5,
               "blocks/We1": D ** -0.5, "blocks/We2": Fe ** -0.5,
               "blocks/W1": D ** -0.5, "blocks/W2": F ** -0.5}
        g = torch.Generator().manual_seed(int(seed))
        items = []
        for path, shape in sorted(self._shapes().items()):
            if path in std:
                t = torch.randn(shape, generator=g) * std[path]
            elif path.endswith("/g"):
                t = torch.ones(shape)
            else:
                t = torch.zeros(shape)
            items.append((path, t.to(c.dtype)))
        return _unflat(items)

    def param_specs(self) -> Dict:
        """The placement of each param leaf: a tuple of axis names (None:
        whole) per dim, the JAX PartitionSpecs."""
        m, p, e = self.ax_m, self.ax_p, self.ax_e
        blk = {
            "ln1": {"g": (p,), "b": (p,)},
            "Wqkv": (p, None, None, m, None),
            "bqkv": (p, None, m, None),
            "Wo": (p, m, None, None),
            "bo": (p,),
            "ln2": {"g": (p,), "b": (p,)},
        }
        if self.config.n_experts:
            blk.update({"Wr": (p, None, None), "We1": (p, e, None, None),
                        "be1": (p, e, None), "We2": (p, e, None, None),
                        "be2": (p, e, None)})
        else:
            blk.update({"W1": (p, None, m), "b1": (p, m),
                        "W2": (p, m, None), "b2": (p,)})
        return {"embed": (), "pos": (), "blocks": blk,
                "lnf": {"g": (), "b": ()}}

    def _slice(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of a whole leaf."""
        for dim, a in enumerate(spec):
            if a is not None:
                ax = self._axis(a)
                t = shard_mod.split_part(t, dim, 1, ax.size, ax.rank)
        return t

    def _join(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf from every rank's slice (collective)."""
        for dim in reversed(range(len(spec))):
            a = spec[dim]
            if a is not None:
                t = self._axis(a).all_gather(t, dim)
        return t

    def _check_whole(self, tree, what: str) -> None:
        shapes = self._shapes()
        have = {p: tuple(v.shape) for p, v in _flat(tree)}
        if set(have) != set(shapes):
            raise ValueError(f"{what}: names {sorted(have)} against "
                             f"{sorted(shapes)}")
        bad = {p: (have[p], shapes[p]) for p in shapes
               if have[p] != shapes[p]}
        if bad:
            raise ValueError(f"{what}: shapes differ {bad}")

    def load_params(self, params, opt_state=None) -> None:
        """Whole params (nested dicts of arrays or tensors in the JAX
        layout; names and shapes checked) and, where given, whole updater
        slots (else a fresh state); each rank keeps its slices on its
        device."""
        specs = self.param_specs()
        dt = self.config.dtype

        def place(v, spec):
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            return self._slice(t.to(dt), spec).to(self.device)

        self._check_whole(params, "params")
        self.params = upd_mod.tree_map(place, params, specs)
        if opt_state is None:
            self.opt_state = self.updater.init_state(self.params)
            return
        state = {}
        for k, v in opt_state.items():
            if isinstance(v, dict):
                self._check_whole(v, f"updater slot {k}")
                state[k] = upd_mod.tree_map(place, v, specs)
            else:
                t = torch.as_tensor(np.asarray(v) if not isinstance(
                    v, torch.Tensor) else v)
                state[k] = t.to(self.device)
        self.opt_state = state

    def whole_params(self) -> Dict:
        """The whole params on every rank, on the host (collective)."""
        return upd_mod.tree_map(lambda t, s: self._join(t.detach(), s).cpu(),
                         self.params, self.param_specs())

    def whole_opt_state(self) -> Dict:
        specs = self.param_specs()
        out = {}
        for k, v in (self.opt_state or {}).items():
            out[k] = (upd_mod.tree_map(lambda t, s: self._join(t, s).cpu(), v,
                                specs) if isinstance(v, dict)
                      else v.detach().cpu())
        return out

    # ---------------- blocks ----------------
    def _moe(self, p, m_in):
        """Switch top-1 MoE over the local experts; the gate after the
        combine."""
        ax = self._axis(self.ax_e)
        r = torch.matmul(m_in, p["Wr"])
        probs = torch.softmax(r, dim=-1)
        gate, assign = probs.max(dim=-1)
        x_in = ax.copy(m_in)
        el = p["We1"].shape[0]
        e0 = ax.rank * el
        acc = torch.zeros_like(m_in)
        for j in range(el):
            sel = (assign == e0 + j).to(m_in.dtype)[..., None]
            h = _gelu(torch.matmul(x_in, p["We1"][j]) + p["be1"][j])
            h = torch.matmul(h, p["We2"][j]) + p["be2"][j]
            acc = acc + sel * h
        combined = ax.reduce(acc)
        return gate[..., None] * combined

    def _block(self, p, h, rng=None):
        c = self.config
        b, tl, D = h.shape
        hl = p["Wqkv"].shape[2]  # local heads
        dh = c.head_dim
        tp = self._axis(self.ax_m)
        a_in = tp.copy(_ln(p["ln1"], h))
        qkv = torch.einsum("btd,dchk->bcthk", a_in, p["Wqkv"]) \
            + p["bqkv"][None, :, None, :, :]
        q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))
        o = ring.ring_attention_sharded(
            q, k, v, axis=self._axis(self.ax_s), causal=True,
            block_size=c.attention_block)
        o = o.transpose(1, 2).reshape(b, tl, hl * dh)
        wo = p["Wo"].reshape(hl * dh, D)
        h = h + tp.reduce(torch.matmul(o, wo)) + p["bo"]
        if c.n_experts:
            mlp = self._moe(p, _ln(p["ln2"], h))
        else:
            m_in = tp.copy(_ln(p["ln2"], h))
            hid = _gelu(torch.matmul(m_in, p["W1"]) + p["b1"])
            mlp = tp.reduce(torch.matmul(hid, p["W2"])) + p["b2"]
        return h + mlp

    def _stage(self, blocks, h):
        """This rank's slice of the stacked blocks, in order, each under
        the config's remat policy."""
        n_local = next(iter(_flat(blocks)))[1].shape[0]
        blk = layout_mod.maybe_remat(self._block, self.config.remat)
        for i in range(n_local):
            h = blk(upd_mod.tree_map(lambda a: a[i], blocks), h)
        return h

    def _embed(self, params, ids):
        tl = ids.shape[1]
        off = self._axis(self.ax_s).rank * tl
        return params["embed"][ids] + params["pos"][off:off + tl][None]

    def _head(self, params, h):
        return torch.matmul(_ln(params["lnf"], h), params["embed"].t())

    def _microbatches(self, b: int) -> int:
        M = self.config.microbatches or self._pp
        if b % M:
            raise ValueError(f"local batch {b} must divide into "
                             f"microbatches={M}")
        return M

    # ---------------- forward ----------------
    def _forward_local(self, params, ids):
        """ids [b_loc, t_loc] -> logits [b_loc, t_loc, vocab] on every
        pipe rank (the last stage's, summed over pipe from it), no
        gradient."""
        h = self._embed(params, ids)
        pp = self._pp
        if pp == 1:
            return self._head(params, self._stage(params["blocks"], h))
        pipe = self._axis(self.ax_p)
        outs = self._pipe_forward(params["blocks"], h)[1]
        logits = (self._head(params, torch.cat(outs)) if pipe.rank == pp - 1
                  else torch.zeros(h.shape[:2] + (self.config.vocab,),
                                   dtype=h.dtype, device=h.device))
        return pipe.all_sum(logits)

    def _pipe_forward(self, blocks, h):
        """The GPipe forward of this stage over the microbatches of h:
        (inputs, outputs) per microbatch, each input of a stage after the
        first a leaf that records its gradient."""
        pipe = self._axis(self.ax_p)
        pp, s = pipe.size, pipe.rank
        M = self._microbatches(h.shape[0])
        mbs = h.split(h.shape[0] // M)
        ins, outs, sent = [], [], []
        for m in range(M):
            if s == 0:
                # cut from the embedding's graph: the stage's backward
                # ends here, and the embedding's runs once over all
                x = mbs[m].detach().requires_grad_(torch.is_grad_enabled())
            else:
                x = pipe.recv(mbs[m].shape, h.dtype, h.device, s - 1)
                x.requires_grad_(torch.is_grad_enabled())
            out = self._stage(blocks, x)
            if s < pp - 1:
                sent.append(pipe.send(out, s + 1))
            ins.append(x)
            outs.append(out)
        for w in sent:
            w.wait()
        return ins, outs

    # ---------------- training ----------------
    def _grad_reduce_axes(self, spec) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over: (data, seq), plus
        pipe for the leaves the pipe axis does not split (their compute
        spans stages). Never model or expert: the f and g operators
        complete those cotangents, and split leaves' gradients are their
        own."""
        axes = [self.ax_d, self.ax_s]
        if self._pp > 1 and self.ax_p not in spec:
            axes.append(self.ax_p)
        return tuple(axes)

    def _leaves(self):
        out = []
        for path, t in _flat(self.params):
            t.requires_grad_(True)
            out.append((path, t))
        return out

    def _local_grads(self, ids, targets, weights, total):
        """(this rank's loss term, its gradient per leaf path)."""
        leaves = self._leaves()
        ts = [t for _, t in leaves]
        params = self.params
        pp = self._pp

        def loss_of(logits):
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
            return (nll * weights).sum() / total

        with torch.enable_grad():
            h = self._embed(params, ids)
            if pp == 1:
                loss = loss_of(self._head(params, self._stage(
                    params["blocks"], h)))
                return loss, list(torch.autograd.grad(loss, ts,
                                                      allow_unused=True))
            pipe = self._axis(self.ax_p)
            s = pipe.rank
            ins, outs = self._pipe_forward(params["blocks"], h)
            grads = [None] * len(ts)

            def add(got):
                for j, g in enumerate(got[:len(ts)]):
                    if g is not None:
                        grads[j] = g if grads[j] is None else grads[j] + g

            M = len(outs)
            if s == pp - 1:
                h_all = torch.cat([o.detach() for o in outs])
                h_all.requires_grad_(True)
                loss = loss_of(self._head(params, h_all))
                got = torch.autograd.grad(loss, ts + [h_all],
                                          allow_unused=True)
                add(got)
                d_outs = got[-1].split(h_all.shape[0] // M)
            else:
                loss = torch.zeros((), device=h.device)
            back, d_ins = [], []
            for m in reversed(range(M)):
                g = (d_outs[m] if s == pp - 1 else pipe.recv(
                    outs[m].shape, outs[m].dtype, h.device, s + 1))
                got = torch.autograd.grad(outs[m], ts + [ins[m]],
                                          grad_outputs=g, allow_unused=True)
                add(got)
                if s > 0:
                    back.append(pipe.send(got[-1], s - 1))
                else:
                    d_ins.append(got[-1])
            if s == 0:
                add(torch.autograd.grad(h, ts, grad_outputs=torch.cat(
                    d_ins[::-1]), allow_unused=True))
            for w in back:
                w.wait()
            return loss, grads

    def _shard_data(self, arr: np.ndarray, dtype) -> torch.Tensor:
        """This rank's block of a global [b, t] array: rows over data,
        time over seq."""
        t = torch.as_tensor(np.asarray(arr))
        for dim, a in ((0, self.ax_d), (1, self.ax_s)):
            ax = self._axis(a)
            if t.shape[dim] % ax.size:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} must "
                                 f"divide by the {a} axis ({ax.size})")
            t = shard_mod.split_part(t, dim, 1, ax.size, ax.rank)
        return t.to(device=self.device, dtype=dtype)

    def fit_batch(self, ids: np.ndarray, targets: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> float:
        """One training step on the global batch (the same arrays on
        every rank). ids and targets [b, t] ints; weights [b, t] (1.0
        counts the token) default to ones. Returns the global loss."""
        if self.params is None:
            raise RuntimeError("call init() or restore() first")
        if weights is None:
            weights = np.ones(np.shape(ids), np.float32)
        ids_s = self._shard_data(ids, torch.long)
        tgt_s = self._shard_data(targets, torch.long)
        w_s = self._shard_data(weights, torch.float32)
        batch = self.mesh.batch
        total = batch.all_sum(w_s.sum()).clamp_min(1.0)
        loss, grads = self._local_grads(ids_s, tgt_s, w_s, total)
        specs = dict(_flat(self.param_specs()))
        paths = [p for p, _ in _flat(self.params)]
        grads = [torch.zeros_like(_at(self.params, p)) if g is None else g
                 for p, g in zip(paths, grads)]
        # (data, seq) leaves and (data, seq, pipe) leaves, each group's
        # gradients summed in flat buckets; the loss over (data, seq, pipe)
        split = [self.ax_p in self._grad_reduce_axes(specs[p])
                 for p in paths]
        rep = self.mesh.replica
        out = [None] * len(paths)
        for over_pipe, group in ((True, rep), (False, batch)):
            idx = [i for i, sp in enumerate(split) if sp == over_pipe]
            reducer = shard_mod.BatchShard(group.group, group.rank,
                                           group.size, 1, 1, group.stats)
            score = loss.detach() if over_pipe else torch.zeros_like(
                loss.detach())
            got_score, got = reducer.reduce(score, [grads[i] for i in idx])
            if over_pipe:
                loss = got_score
            for i, g in zip(idx, got):
                out[i] = g
        g_tree = _unflat(zip(paths, out))
        with torch.no_grad():
            steps, self.opt_state = self.updater.apply(
                g_tree, self.opt_state, self.updater.learning_rate)
            self.params = upd_mod.tree_map(
                lambda t, st: (t - st).detach(), self.params, steps)
        self.iteration += 1
        self.score_ = float(loss)
        return self.score_

    def logits(self, ids: np.ndarray) -> np.ndarray:
        """The global logits [b, t, vocab] of the global ids on every rank
        (collective), as numpy."""
        with torch.no_grad():
            out = self._forward_local(self.params,
                                      self._shard_data(ids, torch.long))
            out = self._axis(self.ax_s).all_gather(out, 1)
            out = self._axis(self.ax_d).all_gather(out, 0)
        return out.float().cpu().numpy()

    # ---------------- persistence ----------------
    def save(self, path: str, save_updater: bool = True) -> None:
        """The JAX package's zip of the whole params (and updater slots):
        gathered on every rank (collective), written by global rank 0."""
        from deeplearning4j_tpu_torch.models.serialization import (
            FORMAT_VERSION,
            _npz_bytes,
        )

        params = self.whole_params()
        opt = self.whole_opt_state() if save_updater else None
        if self.mesh.rank == 0:
            cfg = dataclasses.asdict(self.config)
            cfg["dtype"] = str(self.config.dtype).replace("torch.", "")
            with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr("configuration.json", json.dumps({
                    "transformer_config": cfg,
                    "updater": self.updater.to_json(),
                }))
                z.writestr("coefficients.npz", _npz_bytes(
                    upd_mod.tree_map(lambda t: t.numpy(), params)))
                if opt is not None:
                    z.writestr("updaterState.npz", _npz_bytes({
                        k: (upd_mod.tree_map(lambda t: t.numpy(), v)
                            if isinstance(v, dict) else v.numpy())
                        for k, v in opt.items()}))
                z.writestr("metadata.json", json.dumps({
                    "format_version": FORMAT_VERSION,
                    "model_type": "ShardedTransformerLM",
                    "iteration": int(self.iteration),
                }))
        if self.mesh.size > 1:
            torch.distributed.barrier(group=self.mesh.group)

    @classmethod
    def restore(cls, path: str, mesh: mesh_mod.Grid,
                load_updater: bool = True, device=None,
                **axis_kwargs) -> "ShardedTransformerLM":
        """A checkpoint of either package onto ANY grid: whole tensors,
        each rank keeping its slices of this grid's factorization."""
        from deeplearning4j_tpu_torch.models.serialization import (
            _gather,
            _load_npz,
        )

        with zipfile.ZipFile(path, "r") as z:
            conf = json.loads(z.read("configuration.json").decode())
            meta = json.loads(z.read("metadata.json").decode())
            if meta.get("model_type") != "ShardedTransformerLM":
                raise ValueError(
                    f"{path}: not a ShardedTransformerLM checkpoint "
                    f"(model_type={meta.get('model_type')!r}); use "
                    f"models.serialization.restore_model")
            cfg_d = dict(conf["transformer_config"])
            cfg_d["dtype"] = _DTYPES[str(cfg_d["dtype"])]
            config = TransformerConfig(**cfg_d)
            updater = upd_mod.from_json(conf["updater"])
            lm = cls(config, mesh, updater=updater, device=device,
                     **axis_kwargs)
            template = _unflat((p, None) for p in lm._shapes())
            params = _gather(template, _load_npz(z, "coefficients.npz"))
            opt = None
            upd = _load_npz(z, "updaterState.npz") if load_updater else None
            slots = lm.updater.init_state(upd_mod.tree_map(torch.as_tensor,
                                                           params))
            if upd is not None and isinstance(slots, dict):
                # the updater's slot structure, its arrays from the zip
                opt = {k: (_gather(v, upd, f"{k}/") if isinstance(v, dict)
                           else upd[k]) for k, v in slots.items()}
            lm.load_params(params, opt)
            lm.iteration = int(meta.get("iteration", 0))
        return lm
