"""One rank of the port's ParallelWrapper, run as its own process by
tests/test_torch_parallel.py (gloo on the CPU, a file:// rendezvous). It
imports neither JAX nor the JAX package.

    python tests/torch_dp_worker.py SPEC.json

SPEC names the rank, the world size, the rendezvous, the network (its
config JSON, a ComputationGraph's or a MultiLayerNetwork's, and optional
weights and running state in an .npz of "key/path" entries, the JAX
network's), the data (.npz: x, y and optional fm, lm), the iterator's
batch and epochs, an optional tape of draws to replay, and where to write
what the rank ends with (.npz): its param table ("param/..."), updater
slots ("slot/..."), running state ("state/..."), per-step scores,
iteration, epoch and last_batch_size, the wrapper's reduce counts and
the step windows it ran (the environment's DL4J_TPU_STEP_WINDOW).

Variants, for the tests that must see a fault: "per_rank_bn" takes
BatchNorm's statistics over the rank's rows only (what a wrapper without
the global reduce would do); "refusals" checks the wrapper's refusals and
feeds rank 1 a batch that differs from rank 0's.

On the card (tests/test_torch_cuda.py): "device" "cuda" builds the
networks there and joins gloo with CUDA tensors, "full_precision" turns
TF32 off, each case's results add its kernel launches ("launches/..."),
and a "probe" case checks the collectives and the model axis's autograd
Functions on the device instead of fitting.

The seq and pipe axes (tests/test_torch_sequence_pipeline.py): "mesh"
may name them, "microbatches" is the wrapper's. A "ring" case
(tests/test_torch_ring.py) runs `parallel.ring.ring_attention` on the
global q, k, v (and mask) of its .npz on its mesh and writes the output
and the gradients of sum(o * w); an "lm" case
(tests/test_torch_sharded_transformer.py) builds a ShardedTransformerLM
of its config on its mesh from the JAX params of its .npz (or "restore"s
a checkpoint), fits "steps" steps on the .npz's ids, targets and weights
and writes the losses and the logits, saving a checkpoint after
"save_at" steps where asked.

A "pi" case (tests/test_torch_parallel_inference.py) builds the
network, serves the .npz's requests ("x0", "x1", ...) through
`parallel.ParallelInference` on its mesh from rank 0 ("mode",
"batch_limit", "serving" turns DL4J_TPU_SERVING on), the other ranks in
`follow()` ("full_precision" turns TF32 off), and writes rank 0's
answers ("out0", ...) and each rank's batches served ("direct" serves
through an InferenceServer on the grid instead; "slow" shuts rank 0 down
while a batch is in flight, see `pi_case`).

The model and fsdp axes (tests/test_torch_tensor_parallel.py): "mesh"
names the MeshSpec's axes (default: every rank on the data axis),
"remat" sets every layer's remat policy, "window" sets
DL4J_TPU_STEP_WINDOW for the case, "resume" fits in two parts through a
CheckpointManager under the given directory, one per rank (the second
part a new network and wrapper restored from it, on "resume_mesh" where
given), beside an unbroken run; "sync" adds the params after
`sync_to_host` ("synced/...") and whether every rank then holds them
whole, then fits one epoch more ("refit_sliced", "refit_score"); "table" (.npz of a whole param table) is loaded by
`set_param_table` into the wrapped network before it fits. Each rank also
writes how many elements of each param and updater slot it holds at rest
("local/...") and the collectives of every axis ("coll/<axis>"). A spec
with "cases" runs several such specs in one process group, one after
another.
"""
import collections
import contextlib
import json
import os
import sys
import threading
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deeplearning4j_tpu_torch import dtypes, interop  # noqa: E402
from deeplearning4j_tpu_torch.datasets import (  # noqa: E402
    DataSet,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models import (  # noqa: E402
    ComputationGraph,
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models._training import flat_items  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph_conf import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import normalization  # noqa: E402
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    MeshSpec,
    ParallelWrapper,
    init_process_group,
)


class Tape:
    """Stands in for a network's draws: records what `inner` hands out
    (`record`), or hands the recorded samples out again in order
    (`replay`), refusing a call that does not match the recorded one."""

    def __init__(self, inner, tape):
        self.inner, self.tape = inner, tape

    @classmethod
    def record(cls, inner):
        return cls(inner, [])

    @classmethod
    def replay(cls, taken):
        return cls(None, collections.deque(taken))

    def _child(self, inner):
        return Tape(inner, self.tape)

    def step(self):
        return self._child(self.inner and self.inner.step())

    def split(self, n):
        if self.inner is None:
            return [self] * n
        return [self._child(d) for d in self.inner.split(n)]

    def fold_in(self, data):
        return self._child(self.inner and self.inner.fold_in(data))

    def _take(self, what, shape, draw):
        if self.inner is not None:
            t = draw(self.inner)
            self.tape.append((what, t))
            return t
        got, t = self.tape.popleft()
        if got != what or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"replayed draws out of step: recorded "
                                 f"{got} {tuple(t.shape)}, asked {what} "
                                 f"{tuple(shape)}")
        return t

    def bernoulli(self, p, shape):
        return self._take(["bernoulli", float(p)], shape,
                          lambda d: d.bernoulli(p, shape))

    def normal(self, shape, dtype):
        return self._take(["normal", str(dtype)], shape,
                          lambda d: d.normal(shape, dtype))

    def save(self, path):
        np.savez(path, what=json.dumps([w for w, _ in self.tape]),
                 **{f"t{i}": t.numpy() for i, (_, t) in enumerate(self.tape)})

    @classmethod
    def load(cls, path):
        z = np.load(path)
        whats = json.loads(str(z["what"]))
        return cls.replay([(w, torch.from_numpy(z[f"t{i}"]))
                           for i, w in enumerate(whats)])


def unflatten(flat):
    """{"key/a/b": array} -> {"key": {"a": {"b": array}}}."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = v
    return tree


def build(spec):
    """The port network of the spec on the CPU, with the given weights,
    running state and draws (a "keras" spec imports its .h5 instead)."""
    if spec.get("keras"):
        from deeplearning4j_tpu_torch.modelimport import (
            import_keras_sequential_model_and_weights,
        )

        return import_keras_sequential_model_and_weights(
            spec["keras"], device=spec.get("device", "cpu"))
    if spec["kind"] == "cg":
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            spec["conf"]))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            spec["conf"]))
    net.init(device=spec.get("device", "cpu"))
    if spec.get("weights"):
        z = np.load(spec["weights"])
        params = unflatten({k[len("param/"):]: z[k] for k in z.files
                            if k.startswith("param/")})
        state = unflatten({k[len("state/"):]: z[k] for k in z.files
                           if k.startswith("state/")})
        for k in net.params:
            params.setdefault(k, {})
        for k in net.state:
            state.setdefault(k, {})
        interop.params_from_jax(net, params, state)
    if spec.get("tape"):
        net.draws = Tape.load(spec["tape"])
    return net


def dataset(spec):
    z = np.load(spec["data"])
    return DataSet(z["x"], z["y"], z["fm"] if "fm" in z.files else None,
                   z["lm"] if "lm" in z.files else None)


class Scores:
    def __init__(self):
        self.scores = []
        self.windows = 0  # step windows run (DL4J_TPU_STEP_WINDOW > 1)

    def iteration_done(self, net, iteration, score):
        self.scores.append(score)

    def on_window_start(self, net):
        self.windows += 1


def results(net, scores, stats=None):
    """What a network ends with, as .npz entries (with a wrapper's
    `stats`, its reduce counts)."""
    out = {f"param/{k}": v for k, v in net.get_param_table().items()}
    slots = interop.opt_state_to_jax(net)
    entries = slots.items() if isinstance(slots, dict) else enumerate(slots)
    for key, entry in entries:
        for slot, tree in (entry or {}).items():
            leaves = (flat_items(tree) if isinstance(tree, dict)
                      else [("", tree)])
            for path, leaf in leaves:
                out[f"slot/{key}/{slot}/{path}"] = np.asarray(leaf)
    for key, st in net.state.items():
        for name, t in st.items():
            out[f"state/{key}/{name}"] = t.detach().cpu().numpy()
    out.update(scores=np.asarray(scores, np.float64),
               iteration=net.iteration, epoch=net.epoch,
               last_batch_size=net.last_batch_size)
    if stats is not None:
        out.update(reduced_bytes=stats.bytes, collectives=stats.collectives,
                   steps=stats.steps)
    return out


def refusals(spec, net):
    """The wrapper's refusals, as {check: error text}."""
    seen = {}
    for name, ms, exc in (("world", MeshSpec(data=spec["world"] + 1),
                           ValueError),
                          ("axis", MeshSpec(data=spec["world"], dcn=2),
                           ValueError)):
        try:
            ParallelWrapper(net, mesh_spec=ms)
        except exc as e:
            seen[name] = str(e)
    pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=spec["world"]))
    ds = dataset(spec)
    if spec["rank"] == 1:
        ds.features = ds.features.copy()
        ds.features[0, 0] += 1.0
    try:
        pw.fit(ListDataSetIterator(ds, batch=spec["batch"]))
    except ValueError as e:
        seen["batch"] = str(e)
    return seen


def at_rest(net):
    """Elements of each param and updater slot this rank holds."""
    out = {}
    for key, p in net.params.items():
        for path, t in flat_items(p):
            out[f"local/param/{key}/{path}"] = t.numel()
    entries = (net.opt_state.items() if isinstance(net.opt_state, dict)
               else zip(net.params, net.opt_state))
    for key, entry in entries:
        for slot, tree in (entry if isinstance(entry, dict) else {}).items():
            leaves = (flat_items(tree) if isinstance(tree, dict)
                      else [("", tree)])
            for path, t in leaves:
                out[f"local/slot/{key}/{slot}/{path}"] = t.numel()
    return out


def fit_case(spec):
    """One case: its network fitted through the wrapper on its mesh;
    returns the .npz entries."""
    net = build(spec)
    if spec.get("remat"):
        layers = (net.layers if hasattr(net, "layers") else
                  [net.layer(n) for n in net.topo if net.layer(n)])
        for layer in layers:
            layer.remat = spec["remat"]
    mesh = MeshSpec(**spec.get("mesh", {"data": spec["world"]}))

    def fit(net, epochs, mesh=mesh, **att):
        log = Scores()
        net.set_listeners(log)
        pw = ParallelWrapper(net, mesh_spec=mesh,
                             microbatches=spec.get("microbatches"))
        if spec.get("table"):
            net.set_param_table(dict(np.load(spec["table"])))
        pw.fit(ListDataSetIterator(dataset(spec), batch=spec["batch"],
                                   shuffle_each_epoch=spec.get("shuffle",
                                                               False)),
               epochs=epochs, **att)
        return log, pw

    old = os.environ.get("DL4J_TPU_STEP_WINDOW")
    if spec.get("window"):
        os.environ["DL4J_TPU_STEP_WINDOW"] = str(spec["window"])
    precision = (dtypes.full_precision() if spec.get("full_precision")
                 else contextlib.nullcontext())
    before = launch_counts()
    try:
        precision.__enter__()
        extra = {}
        if spec.get("resume"):
            from deeplearning4j_tpu_torch.resilience import CheckpointManager

            # every rank saves to a manager of its own
            own = os.path.join(spec["resume"], f"rank{spec['rank']}")
            fit(net, spec["epochs"] // 2,
                checkpoint_manager=CheckpointManager(own))
            net = build(spec)
            log, pw = fit(net, spec["epochs"], mesh=MeshSpec(
                **spec.get("resume_mesh", spec.get("mesh"))),
                checkpoint_manager=CheckpointManager(own))
            control = build(spec)
            clog, _ = fit(control, spec["epochs"])
            extra = {f"control/{k}": v for k, v in results(
                control, clog.scores).items()}
        else:
            log, pw = fit(net, spec["epochs"])
    finally:
        precision.__exit__(None, None, None)
        if old is None:
            os.environ.pop("DL4J_TPU_STEP_WINDOW", None)
        else:
            os.environ["DL4J_TPU_STEP_WINDOW"] = old
    if spec.get("tape") and net.draws.tape:
        raise AssertionError(f"{len(net.draws.tape)} recorded draws "
                             f"left over")
    out = dict(at_rest(net), windows=log.windows, **extra)
    out.update({f"launches/{k}": v - before[k]
                for k, v in launch_counts().items()})
    for axis, st in pw.collective_stats().items():
        out[f"coll/{axis}"] = st["collectives"]
    out.update(results(net, log.scores, pw.stats))
    if spec.get("sync"):
        pw.sync_to_host()
        whole = at_rest(net)
        out["synced_whole"] = all(
            whole[k] == out[f"param/{k[len('local/param/'):]}"].size
            for k in whole if k.startswith("local/param/"))
        out.update({f"synced/{k}": v
                    for k, v in net.get_param_table().items()})
        # one epoch more: the wrapper places the whole params again
        pw.fit(ListDataSetIterator(dataset(spec), batch=spec["batch"]))
        again = at_rest(net)
        out["refit_sliced"] = any(
            again[k] < out[f"param/{k[len('local/param/'):]}"].size
            for k in again if k.startswith("local/param/"))
        out["refit_score"] = net.score_
    return out


def launch_counts():
    """The kernels' launch counters (they count on CUDA tensors only)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import xent_kernel as xk

    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "lstm_scan": lstm_ops.lstm_scan.launches,
            "lstm_scan_bwd": lstm_ops.lstm_scan_bwd.launches,
            "linear_xent_fwd": xk.linear_xent_fwd.launches}


def probe(spec):
    """The collectives and the model axis's Functions on the device: an
    all-gather and an all-reduce of each rank's tensor, and the gradients
    through AxisGroup.copy (f), reduce (g) and gather, for this rank's
    slice of x = arange(8) scaled by rank + 1."""
    from deeplearning4j_tpu_torch.parallel import MeshSpec, build_mesh

    grid = build_mesh(MeshSpec(model=spec["world"]))
    axis, r = grid.model, grid.rank
    dev = torch.device(spec.get("device", "cpu"))
    t = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    out = {"all_gather": axis.all_gather(t, 0).cpu().numpy(),
           "all_reduce": axis.all_sum(t).cpu().numpy()}
    w = torch.arange(8, dtype=torch.float32, device=dev) + 1
    for name, fn in (("copy", lambda x: axis.copy(x) * (r + 1)),
                     ("reduce", lambda x: axis.reduce(x * (r + 1))),
                     ("gather", lambda x: axis.gather(x * (r + 1), 0))):
        x = (torch.arange(8, dtype=torch.float32, device=dev)
             if name != "gather" else axis.slice(
                 torch.arange(8, dtype=torch.float32, device=dev), 0))
        x.requires_grad_(True)
        y = fn(x)
        ww = w if y.shape[0] == 8 else axis.slice(w, 0)
        (y * ww).sum().backward()
        out[f"{name}/y"] = y.detach().cpu().numpy()
        out[f"{name}/grad"] = x.grad.cpu().numpy()
    out["device"] = str(t.device)
    return out


_GRIDS = {}


def grid_of(mesh):
    """The grid of a mesh dict, built once per process group."""
    from deeplearning4j_tpu_torch.parallel import build_mesh

    key = tuple(sorted(mesh.items()))
    if key not in _GRIDS:
        _GRIDS[key] = build_mesh(MeshSpec(**mesh))
    return _GRIDS[key]


def ring_case(spec):
    """Ring attention over global inputs: the output and the gradients of
    sum(o * w) with respect to q, k and v."""
    from deeplearning4j_tpu_torch.parallel import ring

    z = np.load(spec["data"])
    dev = spec.get("device", "cpu")
    dt = getattr(torch, spec.get("dtype", "float32"))
    q, k, v = (torch.from_numpy(z[n]).to(dev, dt).requires_grad_(True)
               for n in ("q", "k", "v"))
    mask = (torch.from_numpy(z["mask"]).to(dev) if "mask" in z.files
            else None)
    before = launch_counts()
    grid = grid_of(spec["mesh"])
    hops = grid.seq.stats.collectives
    o = ring.ring_attention(q, k, v, grid, mask=mask,
                            causal=spec["causal"],
                            block_size=spec.get("block_size"))
    (o.float() * torch.from_numpy(z["w"]).to(dev)).sum().backward()
    out = {"o": o.detach().float().cpu().numpy()}
    out.update({f"d{n}": t.grad.float().cpu().numpy()
                for n, t in (("q", q), ("k", k), ("v", v))})
    out["kernel_route"] = ring.kernel_route(q, mask)
    out["hops"] = grid.seq.stats.collectives - hops
    out.update({f"launches/{k}": v - before[k]
                for k, v in launch_counts().items()})
    return out


def lm_case(spec):
    """A ShardedTransformerLM on its mesh: losses, logits, a checkpoint."""
    from deeplearning4j_tpu_torch.parallel import (
        ShardedTransformerLM,
        TransformerConfig,
    )

    grid = grid_of(spec["mesh"])
    dev = spec.get("device", "cpu")
    if spec.get("restore"):
        lm = ShardedTransformerLM.restore(spec["restore"], grid, device=dev)
    else:
        lm = ShardedTransformerLM(TransformerConfig(**spec["config"]), grid,
                                  device=dev)
        z = np.load(spec["weights"])
        interop.sharded_lm_params_from_jax(lm, unflatten(
            {k: z[k] for k in z.files}))
    d = np.load(spec["data"])
    w = d["w"] if "w" in d.files else None
    losses = []
    for i in range(spec["steps"]):
        if spec.get("save_at") == i:
            lm.save(spec["save"])
        losses.append(lm.fit_batch(d["ids"], d["tgt"], w))
    return {"losses": np.asarray(losses, np.float64),
            "logits": lm.logits(d["ids"]), "iteration": lm.iteration,
            "local_wqkv": np.asarray(lm.params["blocks"]["Wqkv"].shape)}


def pi_case(spec):
    """ParallelInference on the case's grid: rank 0 answers every request
    (concurrently), the other ranks follow. With "direct" rank 0 serves
    through an InferenceServer on the grid and the others through
    `parallel.inference.follow`. With "slow" every rank's forward first
    sleeps that many seconds, and rank 0 shuts down with
    "shutdown_timeout" while its one request (x0) is in flight."""
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.parallel.inference import follow
    from deeplearning4j_tpu_torch.serving import InferenceServer

    grid = grid_of(spec["mesh"])
    os.environ.pop("DL4J_TPU_SERVING", None)
    if spec.get("serving"):
        os.environ["DL4J_TPU_SERVING"] = "1"
    net = build(spec)
    started = threading.Event()
    if spec.get("slow"):
        forward = net.output

        def slow_output(x):
            started.set()
            time.sleep(spec["slow"])
            return forward(x)

        net.output = slow_output
    if not spec.get("direct"):
        pi = ParallelInference(net, mesh=grid, mode=spec["mode"],
                               batch_limit=spec["batch_limit"])
    elif grid.rank == 0:
        pi = InferenceServer(model=net, mesh=grid,
                             batch_limit=spec["batch_limit"])
    os.environ.pop("DL4J_TPU_SERVING", None)
    with (dtypes.full_precision() if spec.get("full_precision")
          else contextlib.nullcontext()):
        if grid.rank != 0:
            return {"served": follow(net, grid) if spec.get("direct")
                    else pi.follow()}
        z = np.load(spec["data"])
        xs = [z[f"x{i}"] for i in range(len(z.files))]
        if spec.get("slow"):
            with ThreadPoolExecutor(1) as pool:
                fut = pool.submit(pi.output, xs[0], deadline_s=60.0)
                if not started.wait(60.0):
                    raise RuntimeError("the request never reached the "
                                       "forward")
                t0 = time.perf_counter()
                pi.shutdown(timeout=spec["shutdown_timeout"])
                took = time.perf_counter() - t0
                return {"out0": fut.result(timeout=60.0),
                        "shutdown_s": took}
        try:
            with ThreadPoolExecutor(len(xs)) as pool:
                outs = list(pool.map(
                    lambda x: pi.output(x, deadline_s=60.0), xs))
        finally:
            pi.shutdown()
    return {f"out{i}": o for i, o in enumerate(outs)}


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 2))
    init_process_group(spec["init"], spec["rank"], spec["world"],
                       backend="gloo", device=spec.get("device", "cpu"))
    try:
        for case in spec.get("cases", [spec]):
            case = dict(case, rank=spec["rank"], world=spec["world"])
            if case.get("refusals"):
                with open(case["out"], "w") as f:
                    json.dump(refusals(case, build(case)), f)
                continue
            if case.get("probe"):
                np.savez(case["out"], **probe(case))
                continue
            if case.get("ring"):
                np.savez(case["out"], **ring_case(case))
                continue
            if case.get("lm"):
                np.savez(case["out"], **lm_case(case))
                continue
            if case.get("pi"):
                np.savez(case["out"], **pi_case(case))
                continue
            if case.get("per_rank_bn"):
                normalization.shard_mod = types.SimpleNamespace(
                    current=lambda: None)
            np.savez(case["out"], **fit_case(case))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
