"""The port's command line (deeplearning4j_tpu_torch/cli.py) against the
JAX package's (deeplearning4j_tpu/cli.py): each ported command in both
packages over the same files, or against the same live server.

Compared exactly: the printed tables and exit codes of evaluate, summary,
checkpoints, trace export / summary, postmortem, fleet, serve rollout,
serve fleet and slo (timestamps and paths aside where a line holds one);
`train --device cpu` on a tiny CSV leaves params within 1e-5 absolute of
the JAX CLI's (the port's fit tests' bound; the JAX CLI runs its wrapper
over the 8 virtual devices, the port over a world-size-1 group, each the
single-device step on the global batch); `import-keras` gives the same
param table. The commands whose modules are not ported yet print a
refusal naming their ROADMAP item and exit 2.
"""
import json
import os
import re

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.telemetry import flight as jflight
from deeplearning4j_tpu.telemetry import trace as jtrace
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.resilience import CheckpointManager
from deeplearning4j_tpu_torch.serving import autoscaler, registry, router
from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import trace
from deeplearning4j_tpu_torch.ui import UIServer
from test_torch_fit_telemetry import data, nets
from test_torch_health import reset_all
from test_torch_ui import _stub_factory

ATOL = 1e-5
CLIS = {"jax": jcli, "port": cli}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("DL4J_TPU_TELEMETRY", "DL4J_TPU_CHAOS", "DL4J_TPU_AUTOTUNE",
                "DL4J_TPU_STEP_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_all()
    yield
    reset_all()


def run(capsys, which, argv):
    """(exit code, stdout) of one CLI call."""
    capsys.readouterr()
    rc = CLIS[which].main(argv)
    return rc, capsys.readouterr().out


def both(capsys, argv, port_extra=()):
    return {name: run(capsys, name, list(argv) + (
        list(port_extra) if name == "port" else []))
        for name in CLIS}


@pytest.fixture
def files(tmp_path):
    """The tiny net as a JAX-written zip (both packages restore it) and a
    CSV of its 24 rows (4 features, then the class)."""
    jnet, _ = nets()
    path = str(tmp_path / "m.zip")
    jser.write_model(jnet, path)
    x, y = data()
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.concatenate([x, y.argmax(1)[:, None]], 1),
               delimiter=",", fmt="%.8g")
    return path, str(csv)


def test_train_evaluate_summary_as_jax(capsys, monkeypatch, files,
                                      tmp_path):
    import tempfile

    model, csv = files
    common = ["--data", csv, "--num-classes", "3", "--batch", "8"]
    outs = {name: str(tmp_path / f"{name}.zip") for name in CLIS}
    got = {}
    for name in CLIS:
        extra = ["--device", "cpu"] if name == "port" else []
        got[name] = run(capsys, name, ["train", "--model", model, "--epochs",
                                       "2", "--out", outs[name]] + common
                        + extra)
        if name == "jax":
            # the port's train opens its own world-size-1 group: its
            # rendezvous directory goes when the group closes
            tmp = tmp_path / "tmp"
            tmp.mkdir()
            monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    assert os.listdir(tmp) == []
    assert got["port"][0] == got["jax"][0] == 0
    score = {name: float(re.search(r"score=([-0-9.]+)", out).group(1))
             for name, (_, out) in got.items()}
    assert abs(score["port"] - score["jax"]) <= ATOL
    p_table = serialization.restore_model(outs["port"], device="cpu") \
        .get_param_table()
    j_table = jser.restore_model(outs["jax"]).get_param_table()
    assert sorted(p_table) == sorted(j_table)
    for k in j_table:
        np.testing.assert_allclose(p_table[k], np.asarray(j_table[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    for argv in (["evaluate", "--model", outs["jax"]] + common,
                 ["summary", "--model", outs["jax"], "--json"],
                 ["summary", "--model", outs["jax"], "--batch", "4"]):
        got = both(capsys, argv, ["--device", "cpu"])
        assert got["port"] == got["jax"], argv[0]
        assert got["port"][0] == 0


def test_checkpoints_listing_as_jax(capsys, tmp_path):
    _, pnet = nets()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep_last=5)
    for step in (1, 2, 3):
        pnet.iteration = step
        cm.save(pnet)
    # a torn payload: --verify fails it in both
    with open(cm._zip(2), "r+b") as f:
        f.seek(40)
        f.write(b"\0\0\0\0")
    for argv in (["checkpoints", "--dir", str(tmp_path / "ckpt")],
                 ["checkpoints", "--dir", str(tmp_path / "ckpt"),
                  "--verify"],
                 ["checkpoints", "--dir", str(tmp_path / "ckpt"), "--json"],
                 ["checkpoints", "--dir", str(tmp_path / "none")]):
        got = both(capsys, argv)
        assert got["port"] == got["jax"], argv
    assert got["port"][0] == 1
    # pruning changes the directory: each CLI prunes its own copy
    import shutil

    pruned = {}
    for name in CLIS:
        d = str(tmp_path / f"prune_{name}")
        shutil.copytree(str(tmp_path / "ckpt"), d)
        rc, out = run(capsys, name, ["checkpoints", "--dir", d, "--prune",
                                     "--keep-last", "1"])
        pruned[name] = (rc, out.replace(d, "DIR"), sorted(os.listdir(d)))
    assert pruned["port"] == pruned["jax"]
    assert "pruned 2 checkpoint(s): [1, 2]" in pruned["port"][1]


def test_trace_export_and_summary_as_jax(capsys, tmp_path):
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps({"events": [
        {"key": "fit", "start_time": 1.0 + i, "duration_ms": 10.0 + i,
         "worker": i % 2, "meta": {}} for i in range(4)] + [
        {"key": "split", "start_time": 0.5, "duration_ms": 3.0,
         "worker": None, "meta": {}}]}))
    outs = {}
    for name in CLIS:
        out = str(tmp_path / f"{name}.trace.json")
        got = run(capsys, name, ["trace", "export", "--stats", str(stats),
                                 "--out", out])
        outs[name] = (got[0], got[1].replace(out, "OUT"),
                      json.load(open(out)))
    assert outs["port"][:2] == outs["jax"][:2]
    for argv in (["trace", "summary", "--file", str(stats)],
                 ["trace", "summary", "--file", str(stats), "--json"],
                 ["trace", "summary", "--file",
                  str(tmp_path / "jax.trace.json")],
                 ["trace", "export", "--stats",
                  str(tmp_path / "jax.trace.json"), "--out",
                  str(tmp_path / "x.json")]):
        got = both(capsys, argv)
        assert got["port"] == got["jax"], argv


def test_postmortem_over_both_packages_bundles_as_jax(capsys, monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    d = tmp_path / "flight"
    for f, t, reason in ((jflight, jtrace, "sentry"),
                         (flight, trace, "stall")):
        t.tracer().add_span("step", 1.0, category="train")
        f.dump(reason, note="x")
    paths = flight.list_bundles(str(d))
    assert len(paths) == 2
    for argv in (["postmortem", "--dir", str(d)],
                 ["postmortem", "--dir", str(d), "--reason", "stall"],
                 ["postmortem", "--dir", str(d), "--trace", "nope"],
                 ["postmortem", "--dir", str(d), "--fleet"],
                 ["postmortem", "--dir", str(tmp_path / "empty")],
                 ["postmortem", "--file", str(tmp_path / "missing.json")]):
        got = both(capsys, argv)
        assert got["port"] == got["jax"], argv
    got = both(capsys, ["postmortem", "--file", paths[0]])
    assert got["port"][0] == got["jax"][0] == 0


def test_serve_fleet_slo_against_one_live_server_as_jax(capsys,
                                                        monkeypatch):
    """Both CLIs read the port's UIServer: the rollout and pool tables and
    exit codes of serve rollout, serve fleet and fleet status agree."""
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    server = UIServer(port=0)
    reg = registry.ModelRegistry()
    pool = None
    try:
        url = server.url()
        for version, k, stable in (("v1", 1.0, True), ("v2", 2.0, False)):
            reg.register("m", dispatch=lambda x, k=k: np.asarray(x) * k,
                         version=version, stable=stable, batch_limit=4)
        rt = router.Router(reg)
        rt.start_rollout("m", "v2", stages=(0.5, 1.0), min_requests=1,
                         fast_window_s=60.0, slow_window_s=600.0,
                         latency_threshold_s=10.0)
        pool = autoscaler.Autoscaler(_stub_factory(), min_replicas=1,
                                     max_replicas=2, clock=lambda: 0.0)
        for _ in range(2):
            rt.output("m", np.ones((1, 2), np.float32), deadline_s=30.0)
        for argv in (["serve", "rollout", "--url", url],
                     ["serve", "fleet", "--url", url],
                     ["fleet", "slo", "--url", url]):
            got = both(capsys, argv)
            assert got["port"] == got["jax"], argv
        assert got["port"][0] == 0
        # each fetch polls the collector (frames grow) and measures the
        # clock skew: the table's host, replica, live, missing and spans
        # columns agree
        got = both(capsys, ["fleet", "status", "--url", url])
        cols = {name: [line.split()[:3] + line.split()[5:7]
                       for line in out.splitlines()]
                for name, (_, out) in got.items()}
        assert got["port"][0] == got["jax"][0] == 0
        assert cols["port"] == cols["jax"]
        assert len(cols["port"]) == 3  # the header, the host, a replica
    finally:
        if pool is not None:
            pool.shutdown()
        reg.shutdown()
        server.stop()
    # nothing listens any more: both report the failed fetch
    for argv in (["serve", "rollout", "--url", url, "--timeout", "1"],
                 ["serve", "fleet", "--url", url, "--timeout", "1"]):
        got = both(capsys, argv)
        assert got["port"][0] == got["jax"][0] == 1


def test_slo_status_as_jax(capsys, monkeypatch):
    got = both(capsys, ["slo", "--interval", "0"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1  # the gate is off
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    got = both(capsys, ["slo", "--interval", "0", "--json"])
    assert got["port"][0] == got["jax"][0] == 0
    assert [r["slo"] for r in json.loads(got["port"][1])] == [
        r["slo"] for r in json.loads(got["jax"][1])]


def test_import_keras_as_jax(capsys, tmp_path):
    from test_keras_import import _write_weights

    rng = np.random.default_rng(2)
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 4, "activation": "softmax",
                    "batch_input_shape": [None, 3], "use_bias": True}}]}}
    h5 = str(tmp_path / "m.h5")
    with h5py.File(h5, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        _write_weights(f, "d1", [
            ("kernel:0", rng.standard_normal((3, 4)).astype(np.float32)),
            ("bias:0", rng.standard_normal(4).astype(np.float32))])
    got = {}
    for name in CLIS:
        out = str(tmp_path / f"{name}.zip")
        extra = ["--device", "cpu"] if name == "port" else []
        rc, text = run(capsys, name, ["import-keras", "--h5", h5, "--out",
                                      out] + extra)
        got[name] = (rc, text.replace(out, "OUT"))
    assert got["port"] == got["jax"]
    p = serialization.restore_model(str(tmp_path / "port.zip"),
                                    device="cpu").get_param_table()
    j = jser.restore_model(str(tmp_path / "jax.zip")).get_param_table()
    for k in j:
        np.testing.assert_array_equal(p[k], np.asarray(j[k]))


@pytest.mark.parametrize("argv,item", [
    (["analyze", "--conf", "c.json"], "item 6"),
    (["analyze"], "item 6"),
    (["lint"], "item 6"),
    (["lint", "pkg", "--select", "DLC"], "item 6"),
    (["profile"], "item 3"),
    (["tune"], "item 4"),
    (["tune", "status"], "item 4"),
    (["tune", "log"], "item 4"),
    (["config", "--all"], "item 4"),
    (["knn-server", "--data", "d.csv"], "item 6"),
])
def test_commands_not_ported_yet_exit_2_naming_their_item(capsys, argv,
                                                          item):
    rc, out = run(capsys, "port", argv)
    assert rc == 2
    assert f"ROADMAP A.11 {item}" in out and "not ported yet" in out


def test_ported_commands_refuse_unknown_arguments_as_jax(capsys):
    for name in CLIS:
        with pytest.raises(SystemExit) as e:
            CLIS[name].main(["slo", "--no-such-flag"])
        assert e.value.code == 2
        assert "unrecognized arguments: --no-such-flag" in \
            capsys.readouterr().err


def test_the_port_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "profile"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 2 and "A.11 item 3" in out.stdout
