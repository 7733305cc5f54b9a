#!/usr/bin/env python3
"""Where the time of one served ResNet-50 batch goes on the card, for the
PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 profile_resnet_torch.py [--batch 32] [--iters 20] [--mixed]
                                    [--out profile_out]

Builds the port's zoo ResNet-50 (1000 classes, 224x224x3, random weights
from a seed) on the card, warms it up, then traces `--iters` forwards of
the serving path's dispatch (host array in, `net.output`, result back to
the host) with torch.profiler. Prints, beside the card's name and power
limit: host wall time per batch, the device's busy and idle share of that
window, and device time per batch by category (cuDNN convolutions, the
bn_act kernel, other elementwise kernels, pooling/reductions, copies). The
full per-kernel table goes to <out>/profile_resnet_torch_<mode>.txt.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("bn_act", ("bn_act",)),
    ("conv (cuDNN)", ("conv", "cudnn", "sm90_xmma", "implicit", "winograd",
                      "gemm", "cutlass", "xmma", "fprop", "nhwc", "nvjet")),
    ("copy", ("memcpy", "memset", "copy")),
    ("pool/reduce", ("pool", "reduce", "softmax", "mean")),
    ("elementwise", ("elementwise", "vectorized", "add", "relu",
                     "clamp", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mixed", action="store_true",
                    help="bf16 activations (dtypes.set_mixed_precision)")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the per-kernel table")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_resnet_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.zoo import ResNet50

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dtypes.set_mixed_precision(args.mixed)
    net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                   seed=7).init()
    x = np.random.default_rng(0).standard_normal(
        (args.batch, 224, 224, 3)).astype(np.float32)

    def serve_once():
        return net.output(x).float().cpu().numpy()

    for _ in range(10):
        serve_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        serve_once()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(args.iters):
            serve_once()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) / args.iters * 1e3

    by_cat, device_us = {}, 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += us
        cat = category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    mode = "bf16" if args.mixed else "f32"
    tag = f"({card}; batch {args.batch}, " \
          f"{'bf16 activations' if args.mixed else 'float32, TF32 convs'})"
    print(f"[profile] untraced wall per served batch: {wall_ms:.3f} ms = "
          f"{args.batch / wall_ms * 1e3:.1f} img/s {tag}")
    if device_us == 0:
        print("[profile] the profiler recorded no device time: device "
              "breakdown not measured")
        return 1
    dev_ms = device_us / args.iters / 1e3
    print(f"[profile] traced wall per batch {traced_ms:.3f} ms; device busy "
          f"{dev_ms:.3f} ms ({dev_ms / traced_ms * 100:.1f}%), idle "
          f"{(1 - dev_ms / traced_ms) * 100:.1f}%")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        ms = us / args.iters / 1e3
        print(f"[profile]   {cat:14s} {ms:8.3f} ms/batch  "
              f"{us / device_us * 100:5.1f}% of device time")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"profile_resnet_torch_{mode}.txt"), "w") as f:
        f.write(f"{tag}\n")
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
