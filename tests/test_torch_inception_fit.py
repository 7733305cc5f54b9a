"""`fit` on an imported Keras InceptionV3 (ROADMAP A.3's rest): the port's
.h5 writer makes the file (random He-scaled kernels, seed 0, 10 classes,
107x107x3), each package imports it and trains 2 steps of the same 4
seeded images. The loss is the file's training_config's
(categorical_crossentropy -> mcxent), the 94 BatchNorms take batch
statistics and move their running state, the updater is the importer's
default (Sgd 0.1).

Train-mode BatchNorm renormalizes at every block, so float32 rounding
between the two programs grows through the network (ROADMAP C.4), as in
tests/test_torch_graph_training.py::test_zoo_resnet50_fit_matches_jax:
step 1 is compared closely, step 2 loosely. Measured: step 1's score
3.3e-5 relative (tol 1e-4); each leaf's change from its start within
0.088 in relative L2 norm (tol 0.15; the largest is a beta whose gradient
two train-mode BatchNorms downstream centre away); the running stats
8.5e-5 of each leaf's largest magnitude (tol 2e-4); step 2's score 7.0e-3
(tol 5e-2). At 75x75 the last blocks' statistics span 4 values per
channel and step 1's score already differs by 1.7e-4.
"""
import numpy as np

from deeplearning4j_tpu.modelimport import (
    import_keras_model_and_weights as jimport,
)
from deeplearning4j_tpu_torch.modelimport import (
    import_keras_model_and_weights as timport,
)
from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
    write_inception_v3_h5,
)
from deeplearning4j_tpu_torch.nn.layers import BatchNorm
from test_torch_parallel import jax_results, max_err
from torch_dp_worker import results

SIZE, BATCH, CLASSES = 107, 4, 10


def test_imported_inception_v3_fits_as_jax(tmp_path):
    path = str(tmp_path / "inception_v3.h5")
    write_inception_v3_h5(path, input_shape=(SIZE, SIZE, 3),
                          classes=CLASSES, seed=0)
    tnet = timport(path, device="cpu")
    jnet = jimport(path)
    out = tnet.layer(tnet.conf.network_outputs[0])
    assert out.loss == "mcxent"
    bns = [n for n in tnet.topo if isinstance(tnet.layer(n), BatchNorm)]
    assert len(bns) == 94
    start = {k: v.copy() for k, v in tnet.get_param_table().items()}
    stats0 = {n: tnet.state[n]["mean"].clone() for n in bns}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, BATCH)]

    tnet.fit(x, y)
    jnet.fit(x, y)
    assert abs(tnet.score_ - jnet.score_) <= 1e-4 * abs(jnet.score_)
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        want, got = np.asarray(jt[k]) - start[k], tt[k] - start[k]
        assert np.linalg.norm(got - want) <= 0.15 * np.linalg.norm(want), k
    assert max_err(results(tnet, [0.0]), jax_results(jnet), "state/",
                   rel=True) <= 2e-4
    assert all(not tnet.state[n]["mean"].equal(stats0[n]) for n in bns)

    tnet.fit(x, y)
    jnet.fit(x, y)
    assert abs(tnet.score_ - jnet.score_) <= 5e-2 * abs(jnet.score_)
    assert np.isfinite(tnet.score_) and tnet.iteration == 2
