"""The dcn axis of the port's grid (deeplearning4j_tpu_torch/parallel/mesh.py
and wrapper.py) against the JAX package's ParallelWrapper at the same
MeshSpec and against the port's single-process fit.

The JAX wrapper shards its batch over "data" alone, so a dcn row of its
mesh holds the same rows as its data peers and computes the same
gradients; nothing is reduced over dcn. The port's ranks do the same: at
MeshSpec(dcn=2, data=1) both ranks take the whole global batch and end
every step with the single process's params, bit-identical to each
other. Two gloo ranks run every case in one process group
(tests/torch_dp_worker.py "cases"); JAX runs dcn=2 x data=1 on the first
two virtual devices.

Tolerances are tests/test_torch_parallel.py's: params 2e-5 absolute and
scores 1e-5 relative (test_dense_mln_matches_jax_and_single_process),
running stats and updater slots 1e-4 of each leaf's largest magnitude.
"""
import json
import subprocess
import sys

import jax
import numpy as np

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch.nn.memory import memory_report
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel import MeshSpec
from test_torch_parallel import (
    WORKER,
    Scores,
    _dense_conf,
    _ff_data,
    jax_net,
    jax_results,
    max_err,
    port_fit,
    port_net,
    same_on_every_rank,
    save_data,
    save_weights,
)
from torch_dp_worker import results
from torch_graphs import small_resnet_json

DCN = {"dcn": 2, "data": 1}


def jax_fit_dcn(jnet, data, batch, epochs):
    """The JAX wrapper on a dcn=2 x data=1 mesh of two virtual devices."""
    log = Scores()
    jnet.set_listeners(log)
    mesh = jbuild_mesh(JMeshSpec(dcn=2, data=1), devices=jax.devices()[:2])
    JWrapper(jnet, mesh=mesh).fit(
        JListIterator(jds.DataSet(*data), batch=batch), epochs=epochs)
    return log.scores


def test_dcn_rows_match_jax_and_one_process(tmp_path):
    """A dense MLN (Adam, 3 epochs of one batch of 64) and the small
    ResNet-shaped graph (five BatchNorms, 2 steps of 4 images) at
    MeshSpec(dcn=2, data=1) over two gloo ranks: each rank against the
    JAX wrapper at the same MeshSpec and the single process, the two dcn
    rows bit-identical after their steps."""
    rng = np.random.default_rng(5)
    bn_x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    bn_y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    nets = {
        "dense": ("mln", _dense_conf(), (*_ff_data(0, 64), None, None), 64,
                  3),
        "bn": ("cg", small_resnet_json(), (bn_x, bn_y, None, None), 4, 1),
    }
    refs, cases = {}, {}
    for name, (kind, conf, data, batch, epochs) in nets.items():
        case_dir = tmp_path / name
        case_dir.mkdir()
        jnet = jax_net(kind, conf)
        tnet = port_net(kind, conf, jnet)
        cases[name] = dict(kind=kind, conf=conf,
                           weights=save_weights(case_dir, jnet),
                           data=save_data(case_dir, "data", *data),
                           batch=batch, epochs=epochs, mesh=DCN)
        ts = port_fit(tnet, [None if a is None else a.copy() for a in data],
                      batch, epochs)
        js = jax_fit_dcn(jnet, [None if a is None else a.copy()
                                for a in data], batch, epochs)
        refs[name] = (jax_results(jnet), js, results(tnet, ts), ts)
    procs = []
    for r in range(2):
        spec = {"rank": r, "world": 2, "init": f"file://{tmp_path}/rdv",
                "threads": 1,
                "cases": [dict(c, out=str(tmp_path / f"{n}_rank{r}.npz"))
                          for n, c in cases.items()]}
        path = tmp_path / f"spec{r}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(path)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    for name, (jr, js, tr_, ts) in refs.items():
        ranks = [dict(np.load(tmp_path / f"{name}_rank{r}.npz"))
                 for r in range(2)]
        same_on_every_rank(ranks)
        r0 = ranks[0]
        np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
        np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
        for ref in (jr, tr_):
            assert max_err(r0, ref, "param/") <= 2e-5
        if name == "bn":
            for ref in (jr, tr_):
                assert max_err(r0, ref, "state/", rel=True) <= 1e-4
        else:
            assert max_err(r0, tr_, "slot/", rel=True) <= 1e-4
        # no collective runs on the dcn group
        assert int(r0["coll/dcn"]) == 0
        # every rank holds every param and slot whole
        for k in r0:
            if k.startswith("local/param/"):
                assert int(r0[k]) == r0["param/" + k[len("local/param/"):]
                                        ].size


def test_memory_estimate_against_what_a_dcn_rank_holds():
    """nn/memory.py (as the JAX package's) divides the gradient term by the
    dcn axis; on a real dcn grid each rank of the port holds the whole
    params, slots and gradients (so does each JAX device: the batch is
    sharded over data only), so the estimate is short by exactly
    p - p // dcn bytes. ROADMAP C.17 records it; both packages keep it."""
    conf = MultiLayerConfiguration.from_json(_dense_conf())
    report = memory_report(conf)
    p = report.total_params * 4
    held = p * (1 + report.updater_slots) + p  # params, slots, gradients
    acts = report.training_bytes(1) - p * (2 + report.updater_slots)
    for dcn in (1, 2, 4):
        est = report.training_bytes(1, mesh_spec=MeshSpec(dcn=dcn, data=1))
        assert est - acts == held - (p - p // dcn)
