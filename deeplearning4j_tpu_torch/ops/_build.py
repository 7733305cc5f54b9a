"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. `nvcc`
compiles it for Hopper (`sm_90a`) into `build/lib<name>-<hash>.so` inside
this package (a directory .gitignore lists); the hash of the source and the
compiler flags names the library, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import: the CPU
tests import every module on a machine with no `nvcc`.

    lib = _build.load("bn_act")               # build if needed, then dlopen
    logs = _build.build_all(["bn_act"])       # one nvcc per source, in parallel
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or `nvcc` on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "CUDA kernels build from deeplearning4j_tpu_torch/csrc at first "
            "use")
    return found


def _source(name: str) -> str:
    path = os.path.join(CSRC, f"{name}.cu")
    if not os.path.exists(path):
        raise KernelBuildError(f"no kernel source {path}")
    return path


def library_path(name: str) -> str:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(_source(name), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` into a temporary file beside its target, or
    return None when the library is already built."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    nvcc, src = nvcc_path(), _source(name)  # raise before any file exists
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    # atomic: a concurrent builder of the same source writes the same bytes
    os.replace(tmp, target)
    return log


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Build every named kernel, one nvcc process per source, all started
    together. Returns name -> compiler log ('' when already built)."""
    with _lock:
        started = {n: _start(n) for n in names}
        logs = {}
        try:
            for n, s in started.items():
                logs[n] = "" if s is None else _finish(n, s)
        finally:
            # a failed build leaves no compiler running and no stray file
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
                    os.remove(s[1])
        return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library for `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
