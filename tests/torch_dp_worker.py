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
"""
import collections
import json
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deeplearning4j_tpu_torch import interop  # noqa: E402
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
    running state and draws."""
    if spec["kind"] == "cg":
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            spec["conf"]))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            spec["conf"]))
    net.init(device="cpu")
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
            out[f"state/{key}/{name}"] = t.detach().numpy()
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
                          ("axis", MeshSpec(data=spec["world"], model=2),
                           NotImplementedError)):
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


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 2))
    init_process_group(spec["init"], spec["rank"], spec["world"],
                       backend="gloo", device="cpu")
    try:
        net = build(spec)
        if spec.get("refusals"):
            with open(spec["out"], "w") as f:
                json.dump(refusals(spec, net), f)
            return
        if spec.get("per_rank_bn"):
            normalization.shard_mod = types.SimpleNamespace(
                current=lambda: None)
        log = Scores()
        net.set_listeners(log)
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=spec["world"]))
        pw.fit(ListDataSetIterator(dataset(spec), batch=spec["batch"],
                                   shuffle_each_epoch=spec.get("shuffle",
                                                               False)),
               epochs=spec["epochs"])
        if spec.get("tape") and net.draws.tape:
            raise AssertionError(f"{len(net.draws.tape)} recorded draws "
                                 f"left over")
        np.savez(spec["out"], windows=log.windows,
                 **results(net, log.scores, pw.stats))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
