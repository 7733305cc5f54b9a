#!/usr/bin/env python3
"""Where the time of one served batch goes on the card, for the PyTorch/CUDA
port (deeplearning4j_tpu_torch): zoo ResNet-50, the zoo TransformerLM with
`--model transformer`, the zoo TextGenerationLSTM with `--model lstm`, or
a Keras InceptionV3 file imported by `import_keras_model_and_weights`
with `--model serve-inception`;
or of one training step of the zoo TransformerLM with `--model train-lm`,
of the zoo TextGenerationLSTM with `--model train-rnn`, or of zoo ResNet-50
with `--model train-resnet`; or, with
`--model lstm-routes`, what the two LSTM kernel families cost; or, with
`--model lstm-split`, where a step of the LSTM kernels goes; or, with
`--model dp-resnet`, what ParallelWrapper's collectives add to a ResNet-50
step at world size 1 over NCCL; or, with `--model split-tf32`, what the
kernels that split float32 into TF32 parts cost.

    python3 profile_resnet_torch.py [--model resnet50|transformer|lstm|
                                     serve-inception|
                                     train-lm|train-rnn|train-resnet|
                                     lstm-routes|lstm-split|dp-resnet|
                                     split-tf32]
                                    [--batch N] [--length T] [--iters 20]
                                    [--mixed] [--parent DIR]
                                    [--out profile_out]

Builds the port's model on the card with random weights from a seed
(ResNet-50: 1000 classes, 224x224x3, batch 32 by default; TransformerLM:
vocab 8192, 512 tokens, d_model 512, 8 heads, 6 blocks, batch 16 by
default; TextGenerationLSTM: 77 characters, 64 steps, two GravesLSTM(256),
one-hot float32 input, batch 64 by default; InceptionV3: 1000 classes,
299x299x3, its .h5 written with random weights from a seed by the port's
`write_inception_v3_h5` into a temporary directory, then imported, batch
32 by default, `inception_preprocess` images), warms it up, then traces
`--iters` forwards of the serving path's dispatch (host array in,
`net.output`, result back to the host) with torch.profiler. `train-lm`
traces `--iters` steps of `MultiLayerNetwork.fit` on one repeated batch of
16 x 512 token ids with one-hot float32 labels (copied from host memory
every step, as `fit` of a host DataSet does), Adam(3e-4). `train-rnn`
traces BPTT steps of the TextGenerationLSTM (RmsProp(1e-2), l2 1e-4) on one
repeated batch of 64 x 64 one-hot characters by default (`--batch 8
--length 4096` is the long-sequence path, on the time-chunked kernels).
`train-resnet` traces `ComputationGraph.fit` steps of ResNet-50 (its own
Nesterovs(0.1, 0.9), l2 1e-4) on one repeated batch of 64 images on the
card with one-hot float32 labels (bfloat16 images under `--mixed`, as
bench.py bench_resnet50 feeds them), and splits the kernel time by the
operation that launched each kernel: convolutions forward and backward,
bn_act and its backward through the plain epilogue, the BatchNorm
statistics' reductions forward and backward, linear_xent, the updater, the
rest by kernel name. Prints, beside
the card's name and power limit: host wall time per batch, the device's
busy and idle share of that window (busy: the union of its kernels'
intervals, as the LSTM backward runs kernels on three streams at once),
and kernel time per batch by category, summed over streams (the port's
kernels, the LSTM ones split into the forward scan (rows 5 and 7, one
kernel), the backward's serial chains (rows 6 and 8: recompute, reverse)
and what runs beside them (dR, the z product, the c scan, R's copies);
cuDNN convolutions and cuBLAS matmuls, other elementwise kernels,
pooling/reductions/softmax, copies). The full per-kernel table goes to
<out>/profile_<resnet|transformer|lstm|serve-inception|train-lm|train-rnn>_torch_<mode>.txt
(train-rnn at another length than 64: train-rnn-t<T>). `lstm-routes`
runs one LSTM layer's forward and backward at (batch, length, 256)
float32, peephole (8 x 4096 by default), through each kernel family: the
full one (rows 5 and 6, `lstm_scan_peephole`) and the time-chunked one
(rows 7 and 8, `lstm_scan_chunked_peephole`), whatever
`chunked_lstm_auto_regime` would pick, and prints each one's time (CUDA
events, median of 5) and peak device memory above its inputs.
`lstm-split` builds csrc/lstm_scan.cu and csrc/lstm_scan_bwd.cu with their
probes on (`-DLSTM_FWD_PROBES`, `-DLSTM_BWD_PROBES`) and prints, float32,
for rows 5 and 7 at (64, 64, 256) and (8, 4096, 256) and for rows 6 and 8
at the training paths' shapes, the µs per step of each phase of the serial
kernels' steps; with `--parent DIR` (a checkout of another commit) it
first times rows 5 and 7 without probes against DIR's forward kernel, in
turns, and says whether their outputs have the same bits. `split-tf32`
times the kernels that split float32 into TF32 parts (csrc/hopper_mma.cuh
`split_tf32`): linear_xent's forward and backward at the TransformerLM's
(8192, 512, 8192) and flash attention's forward, dq and dk/dv at (16, 8,
512, 64) causal, float32 (3xTF32), device ms per call by CUDA events
(chip_smoke.py `device_ms`), and feeds linear_xent two rows holding the
NaNs the card's arithmetic makes (0x7fffffff and 0xffffffff), printing
which rows come out NaN; with `--parent DIR` (for example `git archive
<parent> | tar -x -C DIR`) it runs DIR, this checkout, this checkout, DIR,
each in a process of its own with its kernels built from its sources, one
line per run.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

LM = dict(num_classes=8192, max_length=512, d_model=512, n_heads=8,
          n_layers=6)
RNN = dict(num_classes=77, max_length=64)

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("bn_act", ("bn_act",)),
    ("flash_attention", ("flash_fwd",)),
    ("flash_attention_bwd", ("flash_bwd",)),
    ("linear_xent", ("xent_",)),
    ("lstm_scan", ("lstm_scan",)),              # rows 5 and 7
    # rows 6 and 8: the serial chains (phase 1 recompute, phase 2 reverse),
    # then what runs beside them (dR, the z product and c scan, R's copies)
    ("lstm_bwd", ("lstm_bwd_recompute", "lstm_bwd_reverse")),
    ("lstm_bwd_products", ("lstm_bwd_",)),
    ("conv/matmul", ("conv", "cudnn", "sm90_xmma", "implicit", "winograd",
                     "gemm", "cutlass", "xmma", "fprop", "nhwc", "nvjet")),
    ("copy", ("memcpy", "memset", "copy")),
    ("pool/reduce", ("pool", "reduce", "softmax", "mean")),
    ("elementwise", ("elementwise", "vectorized", "add", "relu",
                     "clamp", "unrolled")),
)


# profiler ranges this script opens (train-resnet); the trace also shows
# each as a span on the device, which is not device work
RANGES = ("bn_stats", "updater")


def busy_us(prof, torch) -> float:
    """The union of the device's kernel and copy intervals in the trace:
    kernels on side streams overlap, so their summed time can exceed the
    wall."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in RANGES
                   and e.time_range.end > e.time_range.start)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def lstm_routes(torch, card, b, t, n=256) -> int:
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        chunked_lstm_auto_regime,
    )
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    leaves = [rnd(b, t, 4 * n), rnd(n, 4 * n, scale=(2.0 / (5 * n)) ** 0.5),
              rnd(3, n, scale=0.3), rnd(b, n, scale=0.5),
              rnd(b, n, scale=0.5)]
    leaves = [a.requires_grad_() for a in leaves]
    gs = (rnd(b, t, n), rnd(b, n), rnd(b, n))
    chunked = chunked_lstm_auto_regime(b, t, n, torch.float32)
    print(f"[profile] LSTM routes at b={b} t={t} n={n} float32 peephole "
          f"({card}); chunked_lstm_auto_regime picks the "
          f"{'chunked' if chunked else 'full'} family")
    for name, scan in (("full (rows 5, 6)", lstm_ops.lstm_scan_peephole),
                       ("chunked (rows 7, 8)",
                        lstm_ops.lstm_scan_chunked_peephole)):
        def run():
            return torch.autograd.grad(scan(*leaves), leaves, gs)

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        print(f"[profile]   {name:19s} forward + backward "
              f"{sorted(times)[2]:.4f} ms (median of 5, CUDA events); peak "
              f"memory above the inputs {peak / 2 ** 30:.4f} GiB")
    return 0


# ----------------------------------------------------- --model lstm-split
# Where a step of the LSTM kernels goes: csrc/lstm_scan.cu built with its
# probes on (-DLSTM_FWD_PROBES) and csrc/lstm_scan_bwd.cu with its own
# (-DLSTM_BWD_PROBES): thread 0 of the first cluster's block 0 reads clock64
# at each phase boundary of every step of the serial kernels and adds the
# cycles up. Run at the paths' shapes, float32, peephole; per phase, µs per
# step, the cycles scaled by the loop's own clock (its %globaltimer time
# over its cycles).
FWD_SPLIT_SHAPES = [((64, 64, 256), False), ((8, 4096, 256), True)]
BWD_SPLIT_SHAPES = [((64, 64, 256), False), ((32, 50, 256), False),
                    ((8, 1024, 256), True), ((8, 4096, 256), True)]
BWD_PHASES = (  # (kernel, first g_probe slot, its phases in PROBE order)
    ("recompute", 0, ("product", "sync", "cell + DSMEM broadcast",
                      "arrive, stores, next loads", "cluster wait")),
    ("reverse", 16, ("cell (dz)", "sync", "product + DSMEM partials",
                     "arrive, stores, next loads", "cluster wait",
                     "gather")))


def build_probed(out: str, name: str, macro: str) -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import _build

    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{name}_probed.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{macro}",
                    "-o", so, os.path.join(_build.CSRC, f"{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(so)


def split_inputs(torch, b, t, n):
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, k=1.0: torch.randn(*s, generator=g, device="cuda") * k
    zx, R = rnd(b, t, 4 * n), rnd(n, 4 * n, k=n ** -0.5)
    p, h0, c0 = rnd(3, n, k=0.1), rnd(b, n, k=0.5), rnd(b, n, k=0.5)
    gs = (rnd(b, t, n), rnd(b, n), rnd(b, n))
    return zx, R, p, h0, c0, gs


def launch_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def probed_run(torch, lib, prefix, slots, fn, t):
    """Time `fn` (probes on), then run it once more with the probe sums
    cleared; returns (ms per launch, the probe sums)."""
    ms = launch_ms(torch, fn, 3 if t > 1000 else 20)
    getattr(lib, prefix + "_probe_reset")()
    fn()
    torch.cuda.synchronize()
    v = (ctypes.c_uint64 * slots)()
    getattr(lib, prefix + "_probe_read")(ctypes.addressof(v))
    return ms, v


def print_phases(kernel, names, v, first, ns_slot, steps_slot):
    steps = v[steps_slot]
    if not steps:
        return
    cycles = sum(v[first:first + len(names)])
    us = v[ns_slot] / 1e3 / cycles  # per cycle
    parts = [v[first + i] * us / steps for i in range(len(names))]
    print(f"  {kernel:9s} " + ", ".join(
        f"{nm} {x:.3f}" for nm, x in zip(names, parts)) +
        f"; total {sum(parts):.3f} ({1 / us:.0f} MHz)")


def fwd_against_parent(torch, L, parent):
    """Rows 5 and 7 at their paths' shapes, float32 and bfloat16, peephole:
    this checkout's forward kernel and the one in `parent` (a checkout of
    another commit), both built without probes, timed in turns (parent,
    change, change, parent; CUDA events), and whether their outputs have
    the same bits."""
    from deeplearning4j_tpu_torch.ops import _build

    libs = {"change": L._fwd_lib()}
    so = os.path.join(parent, "liblstm_scan_parent.so")
    csrc = os.path.join(parent, "deeplearning4j_tpu_torch", "csrc")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(csrc, "lstm_scan.cu")], check=True,
                   capture_output=True)
    libs["parent"] = ctypes.CDLL(so)
    sizes = [ctypes.c_int64] * 3
    libs["parent"].lstm_scan_launch.argtypes = (
        [ctypes.c_void_p] * 9 + sizes + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p])
    libs["parent"].lstm_scan_error_string.restype = ctypes.c_char_p
    libs["parent"].lstm_scan_chunked_launch.argtypes = (
        [ctypes.c_void_p] * 11 + sizes + [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p])
    for (b, t, n), chunked in FWD_SPLIT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            zx, R, p, h0, c0 = (x.to(dtype)
                                for x in split_inputs(torch, b, t, n)[:5])
            fn = ((lambda: L.lstm_scan_chunked_forward(zx, R, h0, c0, p))
                  if chunked else
                  (lambda: L.lstm_scan_peephole(zx, R, p, h0, c0)))
            got, outs = {"parent": [], "change": []}, {}
            for who in ("parent", "change", "change", "parent"):
                L._libs["lstm_scan"] = libs[who]
                got[who].append(launch_ms(torch, fn, 5 if t > 1000 else 50))
                outs[who] = fn()
            L._libs["lstm_scan"] = libs["change"]
            same = all(torch.equal(a, b_) for a, b_ in
                       zip(outs["parent"], outs["change"]))
            print(f"row {7 if chunked else 5} (b, t, n) = ({b}, {t}, {n}) "
                  f"{str(dtype)[6:]}: ms per launch, parent "
                  f"{', '.join(f'{x:.4f}' for x in got['parent'])}; change "
                  f"{', '.join(f'{x:.4f}' for x in got['change'])} "
                  f"({min(got['change']) * 1e3 / t:.3f} us/step; parent "
                  f"{min(got['parent']) * 1e3 / t:.3f}); outputs "
                  f"{'the same bits' if same else 'differ'}")


def lstm_split(torch, card, args) -> int:
    from deeplearning4j_tpu_torch.ops import lstm as L

    print(card)
    if args.parent:
        fwd_against_parent(torch, L, args.parent)
    out = os.path.join(args.out, "lstm_split")
    fwd = build_probed(out, "lstm_scan", "LSTM_FWD_PROBES")
    bwd = build_probed(out, "lstm_scan_bwd", "LSTM_BWD_PROBES")
    L._setup_fwd(fwd)
    L._setup_bwd(bwd)
    L._libs["lstm_scan"], L._libs["lstm_scan_bwd"] = fwd, bwd
    fwd.lstm_scan_probe_names.restype = ctypes.c_char_p
    fwd.lstm_scan_probe_read.argtypes = [ctypes.c_void_p]
    bwd.lstm_scan_bwd_probe_read.argtypes = [ctypes.c_void_p]
    fwd_names = fwd.lstm_scan_probe_names().decode().split(";")
    for (b, t, n), chunked in FWD_SPLIT_SHAPES:
        zx, R, p, h0, c0, _ = split_inputs(torch, b, t, n)
        fn = ((lambda: L.lstm_scan_chunked_forward(zx, R, h0, c0, p))
              if chunked else
              (lambda: L.lstm_scan_peephole(zx, R, p, h0, c0)))
        ms, v = probed_run(torch, fwd, "lstm_scan", 16, fn, t)
        print(f"row {7 if chunked else 5} (b, t, n) = ({b}, {t}, {n}) "
              f"float32: {ms:.4f} ms per launch ({ms * 1e3 / t:.3f} us/step,"
              f" probes on); per step, us (cycles at the loop's own clock, "
              f"by %globaltimer):")
        print_phases("forward", fwd_names, v, 0, 14, 15)
    for (b, t, n), chunked in BWD_SPLIT_SHAPES:
        zx, R, p, h0, c0, gs = split_inputs(torch, b, t, n)
        hs, _, _, hck, cck = L.lstm_scan_chunked_forward(zx, R, h0, c0, p)
        fn = ((lambda: L.lstm_scan_chunked_bwd(zx, R, hck, cck, *gs, p))
              if chunked else
              (lambda: L.lstm_scan_bwd(zx, R, h0, c0, hs, *gs, p)))
        ms, v = probed_run(torch, bwd, "lstm_scan_bwd", 32, fn, t)
        print(f"row {8 if chunked else 6} (b, t, n) = ({b}, {t}, {n}) "
              f"float32: {ms:.4f} ms per launch ({ms * 1e3 / t:.3f} us/step"
              f"); per step, us (cycles at the loop's own clock, by "
              f"%globaltimer):")
        for kernel, first, names in BWD_PHASES:
            print_phases(kernel, names, v, first, first + 6, first + 7)
    return 0


# train-resnet: a kernel's category from the operations that launched it
# (the launching op and its enclosing ranges, innermost first), then from
# its own name; "bn_stats" and "updater" are ranges this script opens
OP_CATEGORIES = (
    ("updater", ("updater",)),
    ("conv backward", ("ConvolutionBackward",)),
    ("bn_act backward (plain epilogue)", ("_BnActBackward",)),
    ("BN statistics backward", ("MeanBackward", "PowBackward",
                                "SubBackward", "ToCopyBackward")),
    ("BN statistics forward", ("bn_stats",)),
    ("conv forward", ("aten::convolution",)),
)


def dp_resnet(torch, card, args) -> int:
    """ResNet-50 steps at batch 64 (--mixed: bfloat16 images) in turns,
    `--iters` rounds of 8 steps each: `fit`; the same network through
    ParallelWrapper at world size 1 over NCCL; and the wrapper with every
    all-reduce made a no-op, which at world size 1 computes the same step
    (each all-reduce is the identity there), so the difference is what the
    collectives cost. Then the host time of one NCCL all-reduce of 256
    floats on an idle card (mean of 1000) and queued behind a 0.2 s sleep
    kernel (median of 5)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ParallelWrapper,
        init_process_group,
    )
    from deeplearning4j_tpu_torch.zoo import ResNet50

    batch = args.batch or 64
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(f"file://{tmp}/rdv", 0, 1)
        try:
            net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                           seed=7).init()
            gen = torch.Generator(device=net.device).manual_seed(0)
            x = torch.randn((batch, 224, 224, 3), generator=gen,
                            device=net.device)
            y = torch.nn.functional.one_hot(torch.randint(
                0, 1000, (batch,), generator=gen, device=net.device),
                1000).float()
            data = DataSet(x.to(torch.bfloat16) if args.mixed else x, y)
            pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=1))
            real = dist.all_reduce

            def noop(t, op=None, group=None, async_op=False):
                return None

            def median_step(fit, n=8):
                out = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fit(data)
                    torch.cuda.synchronize()
                    out.append(time.perf_counter() - t0)
                return sorted(out)[n // 2] * 1e3

            kinds = ("fit", "wrapper", "wrapper, no-op all-reduces")
            rounds = {k: [] for k in kinds}
            pw.fit(data)
            net.fit(data)
            for _ in range(args.iters):
                for kind in kinds:
                    dist.all_reduce = noop if kind.endswith("reduces") \
                        else real
                    try:
                        rounds[kind].append(median_step(
                            net.fit if kind == "fit" else pw.fit))
                    finally:
                        dist.all_reduce = real
            steps = pw.stats.steps
            mode = "bf16 images" if args.mixed else "float32, TF32 convs"
            for kind, ms in rounds.items():
                print(f"[dp-resnet] {kind}: median step "
                      f"{sorted(ms)[len(ms) // 2]:.3f} ms over "
                      f"{len(ms)} rounds ({', '.join(f'{v:.3f}' for v in ms)}"
                      f") ({card}; batch {batch}, {mode})")
            print(f"[dp-resnet] the wrapper's all-reduces per step: "
                  f"{pw.stats.collectives / steps:g} gradient buckets, "
                  f"{2 * 2 * 53} BatchNorm statistics (2 forward, 2 "
                  f"backward, 53 BatchNorms)")
            t = torch.randn(256, device=net.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                dist.all_reduce(t)
            idle = (time.perf_counter() - t0) / 1000 * 1e3
            busy = []
            for _ in range(5):
                torch.cuda.synchronize()
                torch.cuda._sleep(400_000_000)
                t0 = time.perf_counter()
                dist.all_reduce(t)
                busy.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            print(f"[dp-resnet] host time of one NCCL all-reduce of 256 "
                  f"floats: {idle:.4f} ms on an idle card, "
                  f"{sorted(busy)[2]:.4f} ms behind a sleep kernel ({card})")
        finally:
            dist.destroy_process_group()
    return 0


def attribute_by_op(torch):
    """Open a profiler range around each BatchNorm's batch statistics and
    each layer's update, so their kernels can be told apart."""
    from deeplearning4j_tpu_torch.models import _training
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm

    def ranged(fn, name):
        def run(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return run

    BatchNorm.batch_stats = ranged(BatchNorm.batch_stats, RANGES[0])
    _training.update_layer = ranged(_training.update_layer, RANGES[1])


def by_launching_op(prof) -> dict:
    """Kernel time (us) by OP_CATEGORIES of the CPU operation that
    launched each kernel, the port's kernels and the rest by kernel
    name."""
    out = {}
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or ()
        if not kernels:
            continue
        chain, p = [], ev
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in kernels:
            cat = category(k.name)
            if cat not in ("bn_act", "linear_xent"):
                cat = next((c for c, keys in OP_CATEGORIES
                            if any(key in n for n in chain for key in keys)),
                           cat)
            out[cat] = out.get(cat, 0.0) + k.duration
    return out


# ----------------------------------------------------- --model split-tf32
def split_tf32(args) -> int:
    """Runs `split_tf32_tree` on `args.tree`, or in a process of its own
    on each of DIR, this checkout, this checkout, DIR (`--parent DIR`;
    this checkout alone without it)."""
    if args.tree is not None:
        split_tf32_tree(os.path.abspath(args.tree))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = ([args.parent, here, here, args.parent] if args.parent
             else [here])
    for tree in trees:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--model", "split-tf32", "--tree", tree])
        if rc:
            return rc
    return 0


def split_tf32_tree(tree: str) -> None:
    """The split-tf32 times and NaN rows of the kernels in `tree`."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build

    _build.build_all(["linear_xent", "flash_attention", "flash_attention_bwd"])
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import xent_kernel as xk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, v = 8192, 512, 8192
    x = torch.randn(n, d, generator=g, device=dev)
    w = torch.randn(d, v, generator=g, device=dev) * d ** -0.5
    b = torch.randn(v, generator=g, device=dev) * 0.1
    lab = torch.nn.functional.one_hot(
        torch.randint(0, v, (n,), generator=g, device=dev), v).float()
    _, lse, ts, idx, oh = xk.linear_xent_fwd(x, w, b, lab)
    gg = torch.ones(n, device=dev)
    all_onehot = oh.min()
    q, k, vv, do = (torch.randn(16, 8, 512, 64, generator=g, device=dev)
                    for _ in range(4))
    o, l = fa.flash_attention(q, k, vv, causal=True, return_lse=True)
    delta = (do * o).sum(-1)
    calls = {
        "xent_fwd": lambda i: xk.linear_xent_fwd(x, w, b, lab),
        "xent_bwd": lambda i: xk.linear_xent_bwd(x, w, b, lab, idx,
                                                 all_onehot, lse, ts, gg),
        "flash_fwd": lambda i: fa.flash_attention(q, k, vv, causal=True),
        "flash_dq": lambda i: fa.flash_attention_bwd_dq(q, k, vv, do, l,
                                                        delta),
        "flash_dkv": lambda i: fa.flash_attention_bwd_dkv(q, k, vv, do, l,
                                                          delta)}
    ms = {name: cs.device_ms(torch, fn, 1, iters=50)
          for name, fn in calls.items()}
    xn = x[:64].clone()
    xn.view(torch.int32)[3, 5] = 0x7fffffff
    xn.view(torch.int32)[9, 0] = -1  # 0xffffffff
    nan_rows = torch.isnan(xk.linear_xent_fwd(xn, w, b, lab[:64])[0])
    print(f"{tree}: " + " ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
          + f"; NaN rows {nan_rows.nonzero().flatten().tolist()} of [3, 9] "
          f"({cs.card_line()})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("resnet50", "transformer", "lstm",
                                        "serve-inception",
                                        "train-lm", "train-rnn",
                                        "train-resnet", "lstm-routes",
                                        "lstm-split", "dp-resnet",
                                        "split-tf32"),
                    default="resnet50")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per served batch (32 ResNet-50 and "
                         "InceptionV3, 16 TransformerLM, 64 "
                         "TextGenerationLSTM) or per "
                         "training batch (16 train-lm, 64 train-rnn, 64 "
                         "train-resnet), or for lstm-routes (8)")
    ap.add_argument("--length", type=int, default=None,
                    help="characters per row for train-rnn (64) and "
                         "lstm-routes (4096)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mixed", action="store_true",
                    help="bf16 activations (dtypes.set_mixed_precision)")
    ap.add_argument("--parent", default=None,
                    help="lstm-split: also time the forward kernel against "
                         "the one in this checkout of another commit; "
                         "split-tf32: time that checkout in turns with "
                         "this one")
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default="profile_out",
                    help="directory for the per-kernel table (and "
                         "lstm-split's probed builds)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_resnet_torch: no CUDA device", file=sys.stderr)
        return 2
    if args.model == "split-tf32":
        return split_tf32(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.zoo import (
        ResNet50,
        TextGenerationLSTM,
        TransformerLM,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dtypes.set_mixed_precision(args.mixed)
    rng = np.random.default_rng(0)
    if args.model == "lstm-routes":
        return lstm_routes(torch, card, args.batch or 8, args.length or 4096)
    if args.model == "lstm-split":
        return lstm_split(torch, card, args)
    if args.model == "dp-resnet":
        return dp_resnet(torch, card, args)
    if args.model == "resnet50":
        batch = args.batch or 32
        net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                       seed=7).init()
        x = rng.standard_normal((batch, 224, 224, 3)).astype(np.float32)
        per_row, unit, ops = 1, "img/s", "TF32 convs"
    elif args.model == "serve-inception":
        from deeplearning4j_tpu_torch.modelimport import (
            import_keras_model_and_weights,
        )
        from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
            inception_preprocess,
            write_inception_v3_h5,
        )

        batch = args.batch or 32
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "inception_v3.h5")
            write_inception_v3_h5(path, seed=7)
            net = import_keras_model_and_weights(path)
        x = inception_preprocess(rng.integers(0, 256, (batch, 299, 299, 3)))
        per_row, unit, ops = 1, "img/s", "TF32 convs"
    elif args.model == "transformer":
        batch = args.batch or 16
        net = TransformerLM(**LM, seed=7).init()
        x = rng.integers(0, LM["num_classes"],
                         (batch, LM["max_length"])).astype(np.int32)
        per_row, unit, ops = LM["max_length"], "tokens/s", "TF32 matmuls"
    elif args.model == "lstm":
        batch = args.batch or 64
        net = TextGenerationLSTM(**RNN, seed=7).init()
        ids = rng.integers(0, RNN["num_classes"], (batch, RNN["max_length"]))
        x = np.eye(RNN["num_classes"], dtype=np.float32)[ids]
        per_row, unit, ops = RNN["max_length"], "chars/s", "TF32 matmuls"
    elif args.model == "train-rnn":
        from deeplearning4j_tpu_torch.datasets import DataSet

        batch, t = args.batch or 64, args.length or RNN["max_length"]
        net = TextGenerationLSTM(num_classes=RNN["num_classes"],
                                 max_length=t, seed=7).init()
        ids = rng.integers(0, RNN["num_classes"], (batch, t + 1))
        eye = np.eye(RNN["num_classes"], dtype=np.float32)
        x, y = eye[ids[:, :t]], eye[ids[:, 1:]]
        per_row, unit, ops = t, "trained chars/s", "TF32 matmuls"
    elif args.model == "train-resnet":
        from deeplearning4j_tpu_torch.datasets import DataSet

        batch = args.batch or 64
        net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                       seed=7).init()
        gen = torch.Generator(device=net.device).manual_seed(0)
        x = torch.randn((batch, 224, 224, 3), generator=gen,
                        device=net.device)
        if args.mixed:
            x = x.to(torch.bfloat16)
        y = torch.nn.functional.one_hot(torch.randint(
            0, 1000, (batch,), generator=gen, device=net.device),
            1000).float()
        per_row, unit, ops = 1, "trained img/s", "TF32 convs"
    else:
        from deeplearning4j_tpu_torch.datasets import DataSet

        batch = args.batch or 16
        net = TransformerLM(**LM, seed=7).init()
        t, vocab = LM["max_length"], LM["num_classes"]
        ids = rng.integers(0, vocab, (batch, t + 1))
        x = ids[:, :t].astype(np.int32)
        y = np.zeros((batch, t, vocab), np.float32)
        np.put_along_axis(y, ids[:, 1:, None], 1.0, axis=-1)
        per_row, unit, ops = t, "trained tokens/s", "TF32 matmuls"

    def serve_once():
        if args.model.startswith("train-"):
            return net.fit(DataSet(x, y)).score_
        return net.output(x).float().cpu().numpy()

    for _ in range(10):
        serve_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        serve_once()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3

    if args.model == "train-resnet":
        attribute_by_op(torch)  # for the traced steps only
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
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key in RANGES:
            continue
        device_us += us
        cat = category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    if args.model == "train-resnet":
        by_cat = by_launching_op(prof)
        attributed = sum(by_cat.values())
        if abs(attributed - device_us) > 0.01 * device_us:
            print(f"[profile] kernels attributed to their launching "
                  f"operations sum to {attributed / 1e3:.3f} ms of "
                  f"{device_us / 1e3:.3f} ms: the split below is partial")
    mode = "bf16" if args.mixed else "f32"
    tag = f"({card}; {args.model}, batch {batch}, " \
          f"{'bf16 activations' if args.mixed else 'float32, ' + ops})"
    what = "step" if args.model.startswith("train-") else "served batch"
    print(f"[profile] untraced wall per {what}: {wall_ms:.3f} ms = "
          f"{batch * per_row / wall_ms * 1e3:.1f} {unit} {tag}")
    if device_us == 0:
        print("[profile] the profiler recorded no device time: device "
              "breakdown not measured")
        return 1
    dev_ms = busy_us(prof, torch) / args.iters / 1e3
    print(f"[profile] traced wall per batch {traced_ms:.3f} ms; device busy "
          f"{dev_ms:.3f} ms ({dev_ms / traced_ms * 100:.1f}%, the union of "
          f"its kernels' intervals), idle "
          f"{(1 - dev_ms / traced_ms) * 100:.1f}%; kernel time summed over "
          f"streams {device_us / args.iters / 1e3:.3f} ms")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        ms = us / args.iters / 1e3
        print(f"[profile]   {cat:17s} {ms:8.3f} ms/batch  "
              f"{us / device_us * 100:5.1f}% of summed kernel time")
    os.makedirs(args.out, exist_ok=True)
    name = "resnet" if args.model == "resnet50" else args.model
    if args.model == "train-rnn" and per_row != RNN["max_length"]:
        name += f"-t{per_row}"
    with open(os.path.join(args.out,
                           f"profile_{name}_torch_{mode}.txt"), "w") as f:
        f.write(f"{tag}\n")
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
