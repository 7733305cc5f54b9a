"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points run on the CUDA card unless the caller names the CPU, the
precision policy drives PyTorch's TF32 switches, and chip_smoke.py refuses
to run (and prints no result) without a card or without the package."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.earlystopping import LocalFileModelSaver
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import Output
from deeplearning4j_tpu_torch.ops import linear
from deeplearning4j_tpu_torch.resilience import CheckpointManager
from deeplearning4j_tpu_torch.zoo import ResNet50

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        deeplearning4j_tpu_torch.__path__, "deeplearning4j_tpu_torch."))


def test_importing_the_whole_port_loads_no_jax():
    code = ("import sys\n"
            f"for m in {_modules()!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'deeplearning4j_tpu'))\n"
            "print(len(sys.modules), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
    assert {"deeplearning4j_tpu_torch.cli", "deeplearning4j_tpu_torch.ui",
            "deeplearning4j_tpu_torch.ui.server"} <= set(_modules())


def test_no_source_file_names_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|deeplearning4j_tpu)\b")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    hits = [(f, line) for f in files for line in open(f)
            if pat.match(line)]
    assert len(files) > 20 and hits == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(num_classes=10, input_shape=(32, 32, 3)).init()
    with pytest.raises(RuntimeError):
        ComputationGraph(ResNet50(num_classes=10,
                                  input_shape=(32, 32, 3)).conf()).init()
    assert device_mod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve("meta")
    # what makes networks from checkpoints and early-stopping savers
    net = MultiLayerNetwork(NeuralNetConfiguration(seed=1).list([
        Output(n_out=2, loss="mcxent")]).set_input_type(
        it.feed_forward(3))).init(device="cpu")
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        manager.restore_latest()
    assert manager.restore_latest(device="cpu")[0].device.type == "cpu"
    LocalFileModelSaver(str(tmp_path / "es")).save_best(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalFileModelSaver(str(tmp_path / "es")).get_best()
    assert LocalFileModelSaver(str(tmp_path / "es")).get_best(
        device="cpu").device.type == "cpu"
    # the CLI's commands and the models a UIServer process serves
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models import write_model
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

    zip_path = str(tmp_path / "m.zip")
    write_model(net, zip_path)
    csv = tmp_path / "d.csv"
    csv.write_text("0.1,0.2,0.3,1\n0.4,0.5,0.6,0\n")
    args = ["--model", zip_path, "--data", str(csv), "--num-classes", "2"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train"] + args)
    for cmd in (["evaluate"] + args, ["summary", "--model", zip_path]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(cmd)
    assert cli.main(["summary", "--model", zip_path, "--device",
                     "cpu"]) == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry().register("m", zip_path)


def test_network_used_before_init_raises():
    net = ComputationGraph(ResNet50(num_classes=10,
                                    input_shape=(32, 32, 3)).conf())
    with pytest.raises(RuntimeError, match="init"):
        net.output(np.zeros((1, 32, 32, 3), np.float32))


def test_precision_policy_sets_tf32_switches():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    try:
        linear.dot(a, b)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with dtypes.full_precision():
            assert dtypes.matmul_precision_dtype() is None
            linear.dot(a, b)
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert dtypes.matmul_precision_dtype() == torch.bfloat16
        with dtypes.mixed():
            assert linear.dot(a, b).dtype == torch.bfloat16
        assert linear.dot(a, b).dtype == torch.float32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the port, the script stops even
    when a card is reported."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert "not beside this script" in out.stderr
    assert '"ok"' not in out.stdout
