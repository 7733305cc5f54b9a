#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

  1. build   every CUDA kernel of the served path from
             deeplearning4j_tpu_torch/csrc (one nvcc per source, started
             together), with the build time and ptxas' resource report.
  2. kernel  each kernel against its plain PyTorch version on the card, at
             every (shape, activation) the ResNet-50 path gives it at the
             serving batch, in float32 and bfloat16: max error against the
             stated tolerance, kernel / plain / one-library-call times
             (CUDA events, inputs rotated through more than the 50 MB L2)
             and the least time the card could take (bytes or operations
             over the card's published rates).
  3. serve   the port's main path: zoo ResNet-50 (1000 classes, 224x224x3,
             random weights from a seed) on the card behind InferenceServer
             (batch_limit 32), warmed up, answering concurrent requests of
             1, 3, 8 and 32 rows and then a stream of 32-row requests. Every
             request must resolve OK with finite (n, 1000) softmax rows that
             sum to 1 and agree with net.output on the same rows; every
             kernel's launch count is reset just before this phase and must
             show the kernel ran on every dispatched batch (bn_act: 53
             launches per forward).
  4. refer   the same seeded network on the CPU (plain epilogue, exact
             float32) against the card with TF32 off: every vertex's
             activation must agree.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero when no CUDA device is
available, and when the port's package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SEED = 7
BATCH = 32                 # the server's batch_limit: the serving batch
L2_BYTES = 50 * 2 ** 20    # H100 L2; timing inputs rotate through 2x this
ITERS = 50

# Published rates (NVIDIA data sheets, dense): device-memory bytes/s and
# float32 operations/s outside the tensor cores. The epilogue's bfloat16
# arithmetic also runs on the float32 units.
CARD_RATES = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),      # SXM
    "H200": (4.8e12, 67e12),
}

# Kernels of the served path: name -> (route, source, TPU kernel it replaces)
KERNELS = {
    "bn_act": ("cuda", "deeplearning4j_tpu_torch/csrc/bn_act.cu",
               "deeplearning4j_tpu/ops/pallas_kernels.py:1430"),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published rates for card {name!r}")


def device_ms(torch, fn, nbuf: int) -> float:
    """Mean device time of fn(i) over ITERS calls. A sleep kernel holds the
    stream while the calls are enqueued, so host launch overhead does not
    enter the measurement; `i` cycles through `nbuf` input buffers."""
    for i in range(min(nbuf, 3)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(ITERS):
        fn(i % nbuf)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


# ---------------------------------------------------------------- phase 1
def phase_build():
    from deeplearning4j_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(list(KERNELS))
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(KERNELS)} built in {dt:.2f} s with "
        f"{_build.nvcc_path()}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                log(f"[build]   {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2
def bn_cases(net, batch):
    """(rows, c, act, calls per forward) of every bn_act call the network
    makes, from its BatchNorm vertices' input types."""
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm

    cases = {}
    for name in net.topo:
        layer = net.layer(name)
        if not isinstance(layer, BatchNorm):
            continue
        act = layer.activation or "identity"
        if act not in ("relu", "identity"):
            continue
        t = net.vertex_types[name]
        key = (batch * t.height * t.width, t.channels, act)
        cases[key] = cases.get(key, 0) + 1
    return [(r, c, a, n) for (r, c, a), n in cases.items()]


def phase_kernel(torch, cases, bw, peak):
    from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ulp = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
    rows_out = {}
    max_err = 0.0
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0}
        for rows, c, act, calls in cases:
            item = torch.empty((), dtype=dtype).element_size()
            nbytes = rows * c * item
            nbuf = max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))
            xs = [torch.randn((BATCH, rows // BATCH, c), generator=gen,
                              device=dev).to(dtype) for _ in range(nbuf)]
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            shift = torch.randn(c, generator=gen, device=dev)
            s_x, h_x = scale.to(dtype), shift.to(dtype)

            y = bn_act(xs[0], scale, shift, act)
            ref = bn_act_reference(xs[0], scale, shift, act)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            # 1 ulp of the dtype at the magnitude of the multiply-add's
            # terms: the two programs may round the product differently
            bound = ulp[dtype] * ((xs[0].float() * scale).abs()
                                  + shift.abs()) + 1e-30
            if y.dtype != dtype or y.shape != xs[0].shape or \
                    not bool((err <= bound).all()):
                raise AssertionError(
                    f"bn_act disagrees with its plain version at rows={rows}"
                    f" c={c} act={act} {dtype}: max err "
                    f"{float(err.max())}")
            e = float(err.max())
            max_err = max(max_err, e)
            checked += 1

            k_ms = device_ms(torch, lambda i: bn_act(xs[i], scale, shift,
                                                     act), nbuf)
            p_ms = device_ms(torch, lambda i: bn_act_reference(
                xs[i], scale, shift, act), nbuf)
            if act == "relu":
                lib_name = "clamp_min(addcmul) (2 calls)"
                l_ms = device_ms(torch, lambda i: torch.clamp_min(
                    torch.addcmul(h_x, xs[i], s_x), 0), nbuf)
            else:
                lib_name = "addcmul"
                l_ms = device_ms(torch, lambda i: torch.addcmul(
                    h_x, xs[i], s_x), nbuf)
            moved = 2 * nbytes + 2 * c * 4
            ops = rows * c * (3 if act == "relu" else 2)
            b_ms = max(moved / bw, ops / peak) * 1e3
            by = "bytes" if moved / bw >= ops / peak else "operations"
            log(f"[kernel] bn_act {str(dtype)[6:]:8s} rows={rows:6d} "
                f"c={c:4d} {act:8s} x{calls:2d}/fwd  max_err={e:.3g} "
                f"(tol 1 ulp)  kernel={k_ms:.4f} ms  plain={p_ms:.4f} ms  "
                f"library[{lib_name}]={l_ms:.4f} ms  bound={b_ms:.4f} ms "
                f"({by})")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("bound_ms", b_ms)):
                totals[key] += calls * v
            del xs
        rows_out[dtype] = totals
        log(f"[kernel] bn_act {str(dtype)[6:]} per ResNet-50 forward at "
            f"batch {BATCH} (53 calls): kernel={totals['ms']:.4f} ms  "
            f"plain={totals['plain_ms']:.4f} ms  "
            f"library={totals['library_ms']:.4f} ms  "
            f"bound={totals['bound_ms']:.4f} ms")
    log(f"[kernel] verdict: bn_act agrees with its plain version in "
        f"{checked}/{checked} (shape, activation, dtype) cases, max error "
        f"{max_err:.3g} (tol 1 ulp)")
    return rows_out, max_err


# ---------------------------------------------------------------- phase 3
def phase_serve(torch, np, net, card):
    from deeplearning4j_tpu_torch.ops.bn_act import bn_act
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED)
    direct = net.output
    forwards = [0]

    def counted_output(x):
        forwards[0] += 1
        return direct(x)

    net.output = counted_output  # counts the server's dispatched batches
    t_in = net.conf.input_types[0]
    shape = (t_in.height, t_in.width, t_in.channels)
    classes = net.vertex_types[net.conf.network_outputs[0]].size
    sizes = (1, 3, 8, 32)
    xs = [rng.standard_normal((n, *shape)).astype(np.float32)
          for n in sizes]
    stream = [rng.standard_normal((BATCH, *shape)).astype(np.float32)
              for _ in range(4)]

    def timed(x):
        t0 = time.perf_counter()
        out = server.output(x)
        return out, time.perf_counter() - t0

    bn_act.launches = 0
    t0 = time.perf_counter()
    server = InferenceServer(model=net, batch_limit=BATCH)
    try:
        server.warmup(xs[0])
        torch.cuda.synchronize()
        log(f"[serve] warmup of buckets {server.buckets.sizes} took "
            f"{time.perf_counter() - t0:.2f} s")
        with ThreadPoolExecutor(len(sizes)) as pool:
            first = list(pool.map(timed, xs))
        n_stream = 96
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            streamed = list(pool.map(timed, [stream[i % len(stream)]
                                             for i in range(n_stream)]))
        wall = time.perf_counter() - t1
    finally:
        server.shutdown()
        net.output = direct
    launches = {"bn_act": bn_act.launches}
    per_forward = sum(n for *_, n in bn_cases(net, 1))
    log(f"[serve] {forwards[0]} batches dispatched, bn_act launches "
        f"{launches['bn_act']} ({per_forward} per forward)")
    if per_forward != 53 or launches["bn_act"] != 53 * forwards[0] \
            or forwards[0] == 0:
        raise AssertionError(
            f"bn_act launches {launches['bn_act']} != 53 x "
            f"{forwards[0]} dispatched batches")

    for x, (out, lat) in zip(xs, first):
        n = x.shape[0]
        if out.shape != (n, classes) or not np.isfinite(out).all():
            raise AssertionError(f"request of {n} rows: bad output "
                                 f"{out.shape}")
        if np.abs(out.sum(axis=1) - 1.0).max() > 1e-4:
            raise AssertionError(f"request of {n} rows: softmax rows do "
                                 f"not sum to 1")
        ref = direct(x).cpu().numpy()
        diff = float(np.abs(out - ref).max())
        # TF32 convolutions: cuDNN may pick another algorithm for the
        # padded bucket than for n rows alone
        if diff > 2e-3 or (out.argmax(1) != ref.argmax(1)).any():
            raise AssertionError(f"request of {n} rows: server and "
                                 f"net.output differ by {diff}")
        log(f"[serve] request rows={n:2d} latency={lat * 1e3:.2f} ms  "
            f"max |server - net.output| = {diff:.3g}  ({card})")
    lats = sorted(lat for _, lat in streamed)
    for out, _ in streamed:
        if out.shape != (BATCH, classes) or not np.isfinite(out).all():
            raise AssertionError("streamed request: bad output")
    img_s = n_stream * BATCH / wall
    log(f"[serve] stream: {n_stream} requests x {BATCH} rows in "
        f"{wall:.3f} s = {img_s:.1f} img/s, latency p50 "
        f"{lats[len(lats) // 2] * 1e3:.2f} ms, max {lats[-1] * 1e3:.2f} ms "
        f"({card})")
    return launches


# ---------------------------------------------------------------- phase 4
def phase_reference(torch, np, net):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.models import ComputationGraph

    # same config, same seed: the same weights, drawn on the CPU
    cpu_net = ComputationGraph(net.conf).init(device="cpu")
    t_in = net.conf.input_types[0]
    x = np.random.default_rng(SEED + 1).standard_normal(
        (2, t_in.height, t_in.width, t_in.channels)).astype(np.float32)
    with dtypes.full_precision():
        gpu_acts = net.feed_forward(x)
    cpu_acts = cpu_net.feed_forward(x)
    worst = 0.0
    for name, a, b in zip(["in"] + net.topo, gpu_acts, cpu_acts):
        a, b = a.cpu().numpy(), b.numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, rel)
        # float32 sums in another order on each device, over ~50 layers
        if a.shape != b.shape or rel > 1e-4:
            raise AssertionError(f"vertex {name}: card and CPU differ, "
                                 f"relative {rel:.3g}")
    tf32 = net.output(x).cpu().numpy()
    log(f"[refer] {len(cpu_acts)} activations, card (TF32 off) vs CPU: worst "
        f"relative difference {worst:.3g} (tol 1e-4); softmax with TF32 on "
        f"vs CPU: max {float(np.abs(tf32 - cpu_acts[-1].numpy()).max()):.3g}")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.zoo import ResNet50

    try:
        card = card_line()
        name = torch.cuda.get_device_name(0)
        bw, peak = card_rates(name)
        log(f"[card] {card}; torch {torch.__version__} CUDA "
            f"{torch.version.cuda}; rates used for bounds: {bw / 1e12} TB/s,"
            f" {peak / 1e12} TFLOP/s float32")
        phase_build()
        t0 = time.perf_counter()
        net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                       seed=SEED).init()
        log(f"[serve] ResNet-50 ({net.num_params()} params) on "
            f"{net.device} in {time.perf_counter() - t0:.2f} s")
        times, max_err = phase_kernel(torch, bn_cases(net, BATCH), bw, peak)
        launches = phase_serve(torch, np, net, card)
        phase_reference(torch, np, net)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "deeplearning4j_tpu"))
        if leaked:
            raise AssertionError(f"imported {leaked[:5]}")
    except Exception:
        traceback.print_exc()
        return 1

    f32 = times[torch.float32]
    kernels = []
    for kname, (route, source, replaces) in KERNELS.items():
        kernels.append({
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max_err, "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": "bytes", "library_ms": f32["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
