#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the repository root; needs one card

Builds the port's CUDA kernels from ``slenderobjdet_torch/ops/csrc`` (at
first use, into ``build/torch_kernels/``), then, each phase failing the run
if it fails:

1. NMS kernel vs its plain version at N=5000, max_out 100, thr 0.6,
   integer-pixel boxes, on a sparse and a dense set (B=8 and 32), a set of
   tied scores, a ragged one (B=3, N=4321, 30% valid) and without classes:
   indices and validity must be identical. The kernel alone and the whole
   call are timed on the sparse and dense sets, with the block-wide rounds
   an image took.
2. Fused stem kernels vs ``reference_stem`` at (8, 800, 1344, 3): max abs
   error / max abs value <= 1e-4 in fp32 (CUDA cores), <= 3e-2 in bf16
   (tensor cores); the bf16 kernel again at B=32, at the ragged (2, 36, 52,
   3) and at 16 channels (which the plan sends to the CUDA cores); the
   tensor-core kernel timed in turns with the CUDA-core one and the bf16
   cuDNN stem at B=8 and 32; its SASS must hold tensor-core instructions.
3. Fused bottleneck kernels vs ``reference_bottleneck`` at the five
   distinct stride-1 block shapes of R-50 at 800x1344, B=8, same
   tolerances; then each shape's time at B=8 and B=32 (the whole
   ``fused_bottleneck`` call, weight re-layout included) beside the plain
   version and the bf16 cuDNN block, with TFLOP/s; and a ``cuobjdump
   -sass`` check that the model's wgmma kernels hold HGMMA and bulk copies.
4. The predict path: ``build_model`` on configs/fcos/fcos_R_50_FPN_1x.yaml
   with FUSED_STEM and FUSED_BLOCKS on, bf16, seeded random weights,
   answering 3 requests of 8 uint8 800x1344 images. Launch counts are reset
   just before and read just after; its three kernels must have run. The
   outputs are checked for shape and finiteness and against the same
   weights with the flags off (the cuDNN path).
5. Timings with CUDA events after warm-up: each kernel against its plain
   version at the main-path shapes, and predict img/s at B=8 and B=32 with
   the fused flags on and off.
6. The probe tools: every variant of the fused-kernel probe against its
   plain version at res2_1, res4_1 and res5_1 (B=8; ``full`` bit-exact with
   ``fused_bottleneck``, the others within 3e-2), the DMA-streams tokens
   (relative 1e-5) and the copies (bit-exact at th 1, 7, 32, 200), the DMA
   probe timed beside a plain full read of its input and the copy beside
   ``x * 0.5`` at th 4, 32, 200 for B=8 and 32; then the three tools'
   ``main`` at B=8 with the launch counts reset before and read after.
7. The train step at full width (800x1344, bf16, FUSED_STEM/FUSED_BLOCKS
   on): one step's gradients of a res3, res4, res5 and head weight from the
   fused bf16 model must be non-zero and no further from an fp32 model's
   than 1.5 x the unfused bf16 model's (B=2); 11 steps on one batch of
   SOLVER.IMS_PER_BATCH (16) images with WARMUP_ITERS 0 must launch both
   fused kernels, keep every loss finite and end below step 0's total;
   train img/s with the flags on and off and the peak device memory.

Every kernel's time stands beside its bound, the least time the card could
take: the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its operations over the peak rate of their type (989 TFLOP/s
bf16 tensor cores, 67 TFLOP/s fp32), the H100 SXM's published figures.

Prints the card's ``nvidia-smi`` name and power limit, a JSON line of the
kernels, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a CUDA device or on any failure.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch

from slenderobjdet_torch.tools.card import card_line, cuda_ms

FP32_TOL = 1e-4      # max|diff| / max|ref|, fp32 kernel vs fp32 plain
BF16_TOL = 3e-2      # the same ratio, bf16 kernel vs bf16 plain
HEAD_FACTOR = 1.5    # head outputs: fused error vs fp32 <= 1.5 x unfused's
HEAD_TOL = 0.15      # and <= this ratio (bf16 rounds ~60 layers deep)
SCORE_TOL = 2e-2     # fused vs unfused: scores of matched detections
MATCH_MIN = 0.99     # fused vs unfused: share of detection slots matched

PREDICT_KERNELS = ("nms", "fused_stem", "fused_bottleneck")
PROBE_KERNELS = ("fused_kernel_probe", "dma_streams_probe", "bw_probe")
GRAD_FACTOR = 1.5    # train: fused gradient error vs fp32 <= 1.5 x unfused's
TRAIN_STEPS = 10     # train: steps after step 0 on one batch
DMA_RTOL = 1e-5      # DMA probe tokens: fp32 sums of the same bf16 values

# NVIDIA's published peaks of the H100 SXM (data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12       # device memory
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16
PEAK_FP32_FLOPS = 67e12      # CUDA cores, fp32
NMS_OPS_PER_PAIR = 17        # one round, one candidate: IoU (16) + the argmax compare

# R-50 stride-1 bottleneck shapes at 800x1344: name, H, W, Cin, Cm, Cout,
# projection shortcut, and how many of the 13 fused blocks have this shape.
BLOCKS = [
    ("res2_0", 200, 336, 64, 64, 256, True, 1),
    ("res2_1", 200, 336, 256, 64, 256, False, 2),
    ("res3_1", 100, 168, 512, 128, 512, False, 3),
    ("res4_1", 50, 84, 1024, 256, 1024, False, 5),
    ("res5_1", 25, 42, 2048, 512, 2048, False, 2),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def set_bound(entry, n_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    entry["bound_ms"], entry["bound_by"] = bound_ms(n_bytes, flops, peak_flops)


def log_bounds(kernels):
    for k in kernels.values():
        if "ms" in k and "bound_ms" in k:
            lib = k.get("library_ms")
            log(f"bound {k['name']}: kernel {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']}), {k['bound_ms'] / k['ms']:.3f} of bound; same-function "
                f"PyTorch call " + ("none" if lib is None else f"{lib:.4f} ms"))


# NMS candidate sets: span of the corners, box sides, classes, score steps
# (0: continuous scores), share of valid candidates
NMS_SETS = {
    "sparse": (1200, 8, 300, 80, 0, 0.9),
    "dense": (200, 20, 60, 4, 0, 0.9),
    "ties": (200, 20, 60, 4, 16, 0.9),
    "ragged": (1200, 8, 300, 80, 0, 0.3),
    "crowded": (24, 30, 40, 2, 0, 0.9),     # the survivors run out before 100
}


def nms_inputs(rs, name, B, N, dev):
    """Integer-pixel boxes, scores, classes and a validity mask on the card."""
    span, lo, hi, ncls, steps, share = NMS_SETS[name]
    xy = rs.randint(0, span, (B, N, 2))
    wh = rs.randint(lo, hi, (B, N, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 2), dtype=torch.float32, device=dev)
    sc = rs.rand(B, N)
    scores = torch.tensor(np.floor(sc * (steps + 1)) / steps if steps else sc,
                          dtype=torch.float32, device=dev)
    classes = torch.tensor(rs.randint(0, ncls, (B, N)), device=dev)
    valid = torch.tensor(rs.rand(B, N) < share, device=dev)
    return boxes, scores, classes, valid


def phase_nms(kernels, dev):
    from slenderobjdet_torch.ops.nms import (batched_nms, cuda_batched_nms, cuda_nms,
                                             launch_nms, nms_select)

    rs = np.random.RandomState(0)
    worst = 0

    def check(label, args, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, int((got[0].long() - want[0].long()).abs().max()))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"NMS kernel != plain ({label}): "
                                 f"{int((got[0] != want[0]).sum())} indices differ")
        rounds = torch.zeros(args[0].shape[0], dtype=torch.int32, device=dev)
        launch_nms(*args, 0.6, 100, rounds=rounds)
        kept, rounds = got[1].sum(1).tolist(), rounds.tolist()
        log(f"nms {label}: kernel == plain at B={args[0].shape[0]} N={args[0].shape[1]}, "
            f"kept an image {min(kept)}-{max(kept)} (sum {sum(kept)}), block-wide rounds "
            f"an image {min(rounds)}-{max(rounds)} (mean {np.mean(rounds):.2f})")
        return sum(kept)

    sets = {}
    for name, B, N in (("sparse", 8, 5000), ("dense", 8, 5000), ("ties", 8, 5000),
                       ("ragged", 3, 4321), ("crowded", 8, 5000), ("sparse", 32, 5000),
                       ("dense", 32, 5000)):
        args = nms_inputs(rs, name, B, N, dev)
        kept = check(f"{name} B={B}", args, cuda_batched_nms(*args[:3], 0.6, 100, args[3]),
                     batched_nms(*args[:3], 0.6, 100, args[3]))
        sets[name, B] = (args, kept)
    boxes, scores, _, valid = sets["dense", 8][0]
    check("dense B=8 without classes", (boxes, scores, None, valid),
          cuda_nms(boxes, scores, 0.6, 100, valid), nms_select(boxes, scores, 0.6, 100, valid))

    # the kernel alone and the whole call (inputs prepared; device time of 50
    # launches enqueued behind a held stream, since the kernel is shorter
    # than the host's enqueue), and one call as a caller waits for it (host
    # clock, synchronised)
    for (name, B), (args, kept) in sets.items():
        if name not in ("sparse", "dense"):
            continue
        ms = cuda_ms(lambda: launch_nms(*args, 0.6, 100), 50, queued=True)
        call_ms = cuda_ms(lambda: cuda_batched_nms(*args[:3], 0.6, 100, args[3]), 50,
                          queued=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            cuda_batched_nms(*args[:3], 0.6, 100, args[3])
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 50 * 1e3
        plain_ms = cuda_ms(lambda: batched_nms(*args[:3], 0.6, 100, args[3]), 3)
        # the reference's work: each kept box scans its image's N candidates once
        out = (torch.empty(B, 100, dtype=torch.int32), torch.empty(B, 100, dtype=torch.bool))
        b_ms, b_by = bound_ms(nbytes(*args, *out), kept * args[0].shape[1] * NMS_OPS_PER_PAIR,
                              PEAK_FP32_FLOPS)
        log(f"time nms {name} B={B} N=5000: kernel alone {ms:.4f} ms, cuda_batched_nms call "
            f"{call_ms:.4f} ms (one synchronised call {wall_ms:.4f} ms on the host clock), "
            f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f} of bound")
        if (name, B) == ("dense", 8):
            kernels["nms"].update(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=None)


def stem_inputs(batch, h, w, cs, dev, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(batch, h, w, 3, generator=g) * 50).to(dev)
    wt = (torch.randn(7, 7, 3, cs, generator=g) / 147 ** 0.5).to(dev)
    scale = (torch.rand(cs, generator=g) * 0.5 + 0.75).to(dev)
    bias = (torch.randn(cs, generator=g) * 0.1).to(dev)
    return x, wt, scale, bias


def phase_stem(kernels, dev):
    from slenderobjdet_torch.ops.fused_stem import (fused_stem, launch_stem,
                                                    reference_stem, stem_plan)

    def check(label, x, w, scale, bias, dt, tol, route):
        b, h, wd, _ = x.shape
        cs = w.shape[-1]
        xd = x.to(dt)
        plan = stem_plan(dt, b, h, wd, cs)
        if plan["route"] != route:
            raise AssertionError(f"stem {label}: plan {plan}, expected {route}")
        got = fused_stem(xd, w, scale, bias)
        want = reference_stem(xd, w, scale, bias)
        torch.cuda.synchronize()
        if got.shape != (b, h // 4, wd // 4, cs) or got.dtype != dt:
            raise AssertionError(f"stem output {tuple(got.shape)} {got.dtype}")
        err = ratio(got, want)
        abs_err = float((got.double() - want.double()).abs().max())
        log(f"stem {label} {dt} ({route}): err ratio {err:.3e} (tol {tol}), "
            f"max abs err {abs_err:.4e}")
        if not err <= tol:
            raise AssertionError(f"stem {label} {dt} err {err} > {tol}")
        return abs_err

    x, w, scale, bias = stem_inputs(8, 800, 1344, 64, dev)
    check("B=8 800x1344", x, w, scale, bias, torch.float32, FP32_TOL, "cuda_cores")
    kernels["fused_stem"]["max_abs_err"] = check(
        "B=8 800x1344", x, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")
    check("ragged (2, 36, 52)", *stem_inputs(2, 36, 52, 64, dev, seed=11),
          torch.bfloat16, BF16_TOL, "mma")
    check("ragged (2, 36, 52)", *stem_inputs(2, 36, 52, 64, dev, seed=11),
          torch.float32, FP32_TOL, "cuda_cores")
    check("16 channels (2, 36, 52)", *stem_inputs(2, 36, 52, 16, dev, seed=12),
          torch.bfloat16, BF16_TOL, "cuda_cores")
    x32 = stem_inputs(32, 800, 1344, 64, dev, seed=13)[0].to(torch.bfloat16)
    check("B=32 800x1344", x32, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")

    # the tensor-core kernel in turns with the CUDA-core one and with the
    # flags-off model path (bf16 cuDNN conv, FrozenBN, relu, maxpool)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(torch.bfloat16)
    sc, bc = (t.to(torch.bfloat16).view(1, -1, 1, 1) for t in (scale, bias))

    def unfused(xc):
        y = torch.nn.functional.conv2d(xc, wc, stride=2, padding=3)
        return torch.nn.functional.max_pool2d(torch.relu(y * sc + bc), 3, 2, 1)

    for xb in (x.to(torch.bfloat16), x32):
        batch = xb.shape[0]
        xc = xb.permute(0, 3, 1, 2)
        turns = {"mma": [], "cuda_cores": [], "cudnn": []}
        for route in ("mma", "cuda_cores", "cudnn", "cudnn", "cuda_cores", "mma"):
            fn = (lambda: unfused(xc)) if route == "cudnn" else (
                lambda: launch_stem(xb, w, scale, bias, route=route))
            turns[route].append(cuda_ms(fn, 10))
        ms, old_ms, cudnn_ms = (float(np.mean(turns[r])) for r in ("mma", "cuda_cores", "cudnn"))
        flops = 2 * 147 * 64 * batch * 400 * 672
        out = torch.empty(batch, 200, 336, 64, dtype=torch.bfloat16, device="meta")
        b_ms, b_by = bound_ms(nbytes(xb, out) + 176 * 64 * 2 + 64 * 4, flops)
        log(f"time stem B={batch} 800x1344 bf16: tensor-core kernel {ms:.4f} ms "
            f"({turns['mma']}), CUDA-core kernel {old_ms:.4f} ms, unfused bf16 cuDNN "
            f"path {cudnn_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.3f} of bound, {flops / ms / 1e9:.1f} TFLOP/s")
        if batch == 8:
            plain_ms = cuda_ms(lambda: reference_stem(xb, w, scale, bias), 10)
            log(f"time stem B=8 plain (fp32 conv) {plain_ms:.4f} ms")
            kernels["fused_stem"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=cudnn_ms)
            if not ms < old_ms:
                raise AssertionError(f"stem: tensor cores {ms} ms, CUDA cores {old_ms} ms")


def block_gflop(batch, h, w, cin, cm, cout, proj):
    """The block's multiply-adds x 2, in GFLOP."""
    macs = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    return 2 * batch * h * w * macs / 1e9


def phase_bottleneck(kernels, dev):
    from slenderobjdet_torch.models.backbones.resnet import BottleneckBlock
    from slenderobjdet_torch.ops.fused_bottleneck import (bottleneck_plan,
                                                          fused_bottleneck,
                                                          reference_bottleneck)

    g = torch.Generator(device="cpu").manual_seed(2)
    gd = torch.Generator(device=dev).manual_seed(2)
    totals = {8: [0.0, 0.0, 0.0], 32: [0.0, 0.0, 0.0]}
    worst_abs = 0.0
    bounds = {"bytes": 0.0, "operations": 0.0}   # the 13 blocks' bounds, by side
    for name, h, wd, cin, cm, cout, proj, count in BLOCKS:
        def rnd(*shape, s=1.0):
            return (torch.randn(*shape, generator=g) * s).to(dev)

        x = torch.relu(rnd(8, h, wd, cin))
        w1, b1 = rnd(cin, cm, s=cin ** -0.5), rnd(cm, s=0.1)
        w2, b2 = rnd(3, 3, cm, cm, s=(9 * cm) ** -0.5), rnd(cm, s=0.1)
        w3, b3 = rnd(cm, cout, s=cm ** -0.5), rnd(cout, s=0.1)
        wsc, bsc = (rnd(cin, cout, s=cin ** -0.5), rnd(cout, s=0.1)) if proj else (None, None)
        args = (w1, b1, w2, b2, w3, b3, wsc, bsc)
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            xd = x.to(dt)
            got = fused_bottleneck(xd, *args)
            want = reference_bottleneck(xd, *args)
            torch.cuda.synchronize()
            if got.shape != (8, h, wd, cout) or got.dtype != dt:
                raise AssertionError(f"{name} output {tuple(got.shape)} {got.dtype}")
            err = ratio(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            log(f"bottleneck {name} {dt}: err ratio {err:.3e} (tol {tol}), "
                f"max abs err {abs_err:.4e}")
            if not err <= tol:
                raise AssertionError(f"bottleneck {name} {dt} err {err} > {tol}")
            if dt == torch.bfloat16:
                worst_abs = max(worst_abs, abs_err)
            del got, want
        del x
        block = BottleneckBlock(cin, cout, cm).to(dev, memory_format=torch.channels_last)
        for batch in (8, 32):
            xb = torch.relu(torch.randn(batch, h, wd, cin, generator=gd, device=dev)
                            ).to(torch.bfloat16)
            route = bottleneck_plan(torch.bfloat16, batch, h, wd, cin, cm, cout)["route"]
            ms = cuda_ms(lambda: fused_bottleneck(xb, *args), 5)
            plain_ms = cuda_ms(lambda: reference_bottleneck(xb, *args), 3 if batch == 8 else 2)
            xc = xb.permute(0, 3, 1, 2)
            with torch.no_grad():
                cudnn_ms = cuda_ms(lambda: block(xc), 5)
            gf = block_gflop(batch, h, wd, cin, cm, cout, proj)
            if batch == 8:      # x in, the output out, bf16 weights and fp32 biases once
                moved = nbytes(xb) * (cin + cout) // cin + sum(
                    t.numel() * (2 if t.dim() > 1 else 4) for t in args if t is not None)
                b_ms, b_by = bound_ms(moved, gf * 1e9)
                bounds[b_by] += count * b_ms
            log(f"time bottleneck {name} B={batch} {h}x{wd} bf16 ({route}): kernel "
                f"{ms:.4f} ms ({gf / ms:.1f} TFLOP/s), plain (fp32 convs) "
                f"{plain_ms:.4f} ms, bf16 cuDNN block {cudnn_ms:.4f} ms "
                f"({gf / cudnn_ms:.1f} TFLOP/s)")
            for k, v in enumerate((ms, plain_ms, cudnn_ms)):
                totals[batch][k] += count * v
            del xb, xc
            torch.cuda.empty_cache()
        del block
    for batch, (ms, plain_ms, cudnn_ms) in totals.items():
        log(f"time bottleneck, all 13 fused blocks of R-50 at B={batch}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 cuDNN blocks {cudnn_ms:.4f} ms")
    kernels["fused_bottleneck"].update(
        max_abs_err=worst_abs, ms=totals[8][0], plain_ms=totals[8][1],
        bound_ms=sum(bounds.values()), bound_by=max(bounds, key=bounds.get),
        library_ms=totals[8][2])
    log(f"bound bottleneck, 13 blocks at B=8: {bounds} ms by side (res2 and res3 "
        f"are bound by bytes, res4 and res5 by operations)")
    sass_check()


def sass_check():
    """The model's bf16 wgmma kernel holds HGMMA and the bf16 stem kernel
    HMMA (cuobjdump -sass of the built library, next to nvcc); the wgmma
    kernel's bisection variants are listed too."""
    import re
    import subprocess
    from pathlib import Path

    from slenderobjdet_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "BAR.SYNC": 0, "UBLKCP": 0, "SYNCS": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    model = {}
    for fn, c in counts.items():
        m = re.search(r"conv_wgmma_kernelILi(\d+)ELi(\d)E", fn)
        if m:
            log(f"sass conv_wgmma_kernel<BN={m.group(1)}, mode={m.group(2)}>: {c}")
            if m.group(2) == "0":
                model[m.group(1)] = c
    if sorted(model) != ["128", "256", "64"] or not all(
            c["HGMMA"] > 0 and c["UBLKCP"] > 0 for c in model.values()):
        raise AssertionError(f"the model's wgmma kernels lack HGMMA or bulk copies: {model}")
    stem = [c for fn, c in counts.items() if "stem_mma_kernel" in fn]
    log(f"sass stem_mma_kernel: {stem}")
    if len(stem) != 1 or not (stem[0]["HMMA"] > 0 or stem[0]["HGMMA"] > 0) \
            or stem[0]["UBLKCP"] != 1:
        raise AssertionError(f"the bf16 stem kernel lacks tensor-core instructions "
                             f"or its one weight bulk copy: {stem}")


def flagship_cfg(fused: bool, dtype: str = "bfloat16"):
    from pathlib import Path

    from slenderobjdet_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent
                            / "configs/fcos/fcos_R_50_FPN_1x.yaml"))
    cfg.MODEL.RESNETS.FUSED_STEM = fused
    cfg.MODEL.RESNETS.FUSED_BLOCKS = fused
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    return cfg


def requests(n: int, batch: int, seed: int):
    rs = np.random.RandomState(seed)
    return [{
        "image": rs.randint(0, 256, (batch, 800, 1344, 3)).astype(np.uint8),
        "scale": np.ones((batch,), np.float32),
        "orig_size": np.tile(np.array([[800, 1344]], np.float32), (batch, 1)),
    } for _ in range(n)]


def build_models(dev):
    """The fused bf16 model with seeded weights, and the same weights unfused
    in bf16 (the cuDNN path) and unfused in fp32 (the reference for both).

    FrozenBN buffers are drawn away from identity so the fused seams' folding
    matters, and the cls_logits bias is 0 so scores pass INFERENCE_TH."""
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.models.layers import FrozenBatchNorm

    gen = torch.Generator().manual_seed(0)
    model = build_model(flagship_cfg(True), device=dev, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.scale.numel()
                m.scale.copy_(torch.rand(n, generator=gen) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.05)
        model.head.cls_logits.bias.zero_()
    plain = build_model(flagship_cfg(False), device=dev)
    plain.load_state_dict(model.state_dict())
    ref32 = build_model(flagship_cfg(False, "float32"), device=dev)
    ref32.load_state_dict(model.state_dict())
    return model, plain, ref32


def one_detection_per_class(gen, *models):
    """Make the detections of two roundings of one network comparable.

    Random weights give nearly tied scores, whose order two bf16 programs
    need not share, so detections are compared class by class, and this
    makes every class keep exactly one detection in both:
    - the bbox_pred bias is 12, which saturates the head's exp clamp
      (ltrb = e^9 everywhere): all boxes of a class overlap with IoU > 0.6,
      so NMS keeps one per class;
    - the cls_logits filters are one shared random filter plus a per-class
      one a tenth its size: each location ranks all 80 classes together, so
      every level's top-1000 candidates hold every class (with independent
      filters, classes whose best pair sits near a level's 1000th place
      appear in one program and not in the other)."""
    w = models[0].head.cls_logits.weight
    shared = torch.randn(w.shape[1:], generator=gen) * 0.01
    per_class = torch.randn(w.shape, generator=gen) * 0.001
    with torch.no_grad():
        for m in models:
            m.head.bbox_pred.bias.fill_(12.0)
            m.head.cls_logits.weight.copy_(shared + per_class)


def check_outputs(out, batch: int):
    shapes = {"boxes": (batch, 100, 4), "scores": (batch, 100),
              "classes": (batch, 100), "valid": (batch, 100)}
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise AssertionError(f"{k} shape {tuple(out[k].shape)} != {s}")
    for k in ("boxes", "scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")


def per_class(out, b):
    v = out["valid"][b].cpu().numpy()
    cls = out["classes"][b].cpu().numpy()[v]
    sc = out["scores"][b].float().cpu().numpy()[v]
    bx = out["boxes"][b].float().cpu().numpy()[v]
    return {int(c): (float(s), x) for c, s, x in zip(cls, sc, bx)}


def phase_main_path(kernels, dev, model, plain, ref32):
    from slenderobjdet_torch.ops import _build

    reqs = requests(3, 8, seed=3)
    # Head outputs: the fused model may be no further from the fp32 model
    # than the unfused bf16 model is, by more than HEAD_FACTOR.
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        heads = [m(images) for m in (model, plain, ref32)]
    for part, f_l, p_l, r_l in zip(("logits", "reg", "ctr"), *heads):
        e_f = max(ratio(f, r) for f, r in zip(f_l, r_l))
        e_p = max(ratio(p, r) for p, r in zip(p_l, r_l))
        log(f"head {part} vs fp32: fused bf16 err ratio {e_f:.3e}, unfused "
            f"bf16 {e_p:.3e} (fused <= {HEAD_FACTOR} x unfused and <= {HEAD_TOL})")
        if not (e_f <= HEAD_FACTOR * e_p and e_f <= HEAD_TOL):
            raise AssertionError(f"head {part}: fused err {e_f}, unfused {e_p}")
    del heads, images
    one_detection_per_class(torch.Generator().manual_seed(5), model, plain)

    _build.reset_launch_counts()
    outs = [model.predict(r) for r in reqs]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"main path launches over 3 requests of B=8: {counts}")
    for name in PREDICT_KERNELS:
        kernels[name]["launches"] = counts[name]
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for out in outs:
        check_outputs(out, 8)
    n_valid = sum(int(o["valid"].sum()) for o in outs)
    log(f"main path: {n_valid} valid detections over 24 images")
    if n_valid <= 0:
        raise AssertionError("no valid detections")

    # A slot matches when the other path kept the same class with a score
    # within SCORE_TOL (and the same box, which the saturated regression
    # makes the whole image).
    matched = total = 0
    diffs = []
    for r, out in zip(reqs, outs):
        ref = plain.predict(r)
        check_outputs(ref, 8)
        if not torch.equal(out["valid"].sum(1), ref["valid"].sum(1)):
            raise AssertionError("valid counts differ between fused and unfused")
        for b in range(8):
            f, p = per_class(out, b), per_class(ref, b)
            total += len(f)
            for c, (s, x) in f.items():
                if c in p and np.allclose(x, p[c][1], atol=1e-3):
                    diffs.append(abs(s - p[c][0]))
                    matched += diffs[-1] <= SCORE_TOL
    share = matched / max(total, 1)
    log(f"fused vs unfused detections: {matched}/{total} slots matched by class "
        f"with score diff <= {SCORE_TOL}; score diff median "
        f"{np.median(diffs):.3e}, max {np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"fused vs unfused: {share:.4f} of slots matched")


def phase_throughput(model, plain):
    for batch, iters in ((8, 5), (32, 3)):
        req = requests(1, batch, seed=4)[0]
        for label, m in (("fused", model), ("unfused", plain),
                         ("fused", model), ("unfused", plain)):
            for _ in range(2):
                m.predict(req)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                m.predict(req)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            log(f"time predict B={batch} {label}: {dt * 1e3:.3f} ms/batch, "
                f"{batch / dt:.2f} img/s")


def phase_probes(kernels, dev):
    """Each probe kernel against its plain version, then the probe tools'
    entry points with the launch counts reset before and read after."""
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.ops.bw_probe import bw_copy, reference_copy
    from slenderobjdet_torch.ops.dma_streams_probe import (dma_streams,
                                                           reference_dma_streams)
    from slenderobjdet_torch.ops.fused_bottleneck import (PROBE_MODES,
                                                          fused_bottleneck,
                                                          probe_variant,
                                                          reference_probe_variant)
    from slenderobjdet_torch.tools import bw_probe, dma_streams_probe, fused_kernel_probe

    worst = 0.0
    ms = plain_ms = probe_bound = 0.0
    for name in ("res2_1", "res4_1", "res5_1"):
        h, w, cin, cm, cout = fused_kernel_probe.BLOCKS[name]
        x, weights = fused_kernel_probe.block_inputs(8, h, w, cin, cm, cout, dev, seed=5)
        # what each variant must do: conv1 and conv3 always, conv2 in full or
        # on one tap, or only the copy (dmaonly) or the write (nodma)
        px, wbytes = 8 * h * w, nbytes(*weights)
        macs = {"full": 2 * cin * cm + 9 * cm * cm, "norolls": 2 * cin * cm + 9 * cm * cm,
                "notap": 2 * cin * cm + cm * cm, "noconv2": 2 * cin * cm,
                "dmaonly": 0, "nodma": 0}
        moved = {m: 2 * nbytes(x) + wbytes for m in PROBE_MODES}
        moved.update(dmaonly=2 * nbytes(x), nodma=nbytes(x))
        main = fused_bottleneck(x, *weights)
        for mode in PROBE_MODES:
            got = probe_variant(mode, x, *weights)
            want = reference_probe_variant(mode, x, *weights)
            torch.cuda.synchronize()
            err = ratio(got, want)
            worst = max(worst, float((got.double() - want.double()).abs().max()))
            exact = torch.equal(got, main) if mode == "full" else None
            log(f"probe {name} {mode}: err ratio {err:.3e} (tol {BF16_TOL})"
                + ("" if exact is None else f", == fused_bottleneck: {exact}"))
            if not err <= BF16_TOL or exact is False:
                raise AssertionError(f"probe {name} {mode}: err {err}, exact {exact}")
            if name == "res2_1":
                ms += cuda_ms(lambda: probe_variant(mode, x, *weights), 5)
                plain_ms += cuda_ms(lambda: reference_probe_variant(mode, x, *weights), 3)
                probe_bound += bound_ms(moved[mode], 2 * px * macs[mode])[0]
            del got, want
        del x, weights, main
        torch.cuda.empty_cache()
    log(f"time fused-kernel probe, the six variants at res2_1 B=8: kernels "
        f"{ms:.4f} ms, plain versions {plain_ms:.4f} ms")
    # at res2_1 every variant is bound by its bytes; no one PyTorch call
    # computes the six variants (the tool's cudnn mode is `full` alone)
    kernels["fused_kernel_probe"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                         bound_ms=probe_bound, bound_by="bytes",
                                         library_ms=None)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(8, 200, 336, 256, generator=g, device=dev).to(torch.bfloat16)
    worst = 0.0
    for th, n in ((40, 1), (40, 2), (40, 4), (40, 8), (8, 3), (33, 5)):
        got, want = dma_streams(x, th, n), reference_dma_streams(x, th)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-12)).max())
        worst = max(worst, float((got - want).abs().max()))
        log(f"dma streams th={th} N={n}: {tuple(got.shape)} tokens, max rel err {rel:.3e}")
        if not rel <= DMA_RTOL:
            raise AssertionError(f"dma streams th={th} N={n}: rel err {rel}")
    kernels["dma_streams_probe"].update(
        max_abs_err=worst, ms=cuda_ms(lambda: dma_streams(x, 40, 1), 10),
        plain_ms=cuda_ms(lambda: reference_dma_streams(x, 40), 10), library_ms=None)
    set_bound(kernels["dma_streams_probe"], nbytes(x, dma_streams(x, 40, 1)), 0)
    # the kernel reads every byte of x; reference_dma_streams only the
    # tokens' elements, so a plain full read is the like-for-like time
    full_read_ms = cuda_ms(lambda: torch.sum(x, dtype=torch.float32), 10)
    gb = x.numel() * x.element_size() / 1e9
    log(f"time dma streams B=8 th=40 N=1: kernel {kernels['dma_streams_probe']['ms']:.4f} ms "
        f"({gb / kernels['dma_streams_probe']['ms'] * 1e3:.0f} GB/s), "
        f"reference_dma_streams {kernels['dma_streams_probe']['plain_ms']:.4f} ms, "
        f"plain full read (torch.sum) {full_read_ms:.4f} ms ({gb / full_read_ms * 1e3:.0f} GB/s)")
    for mode in ("blocked", "chunked"):
        for th in (1, 7, 32, 200):
            if not torch.equal(bw_copy(x, th, mode), reference_copy(x)):
                raise AssertionError(f"bw copy {mode} th={th} != x * 0.5")
    log("bw copy blocked/chunked at th 1, 7, 32, 200: bit-exact with x * 0.5")
    # the copy beside x * 0.5, in turns, at the tool's th values
    for batch in (8, 32):
        xb = x if batch == 8 else torch.randn(
            32, 200, 336, 256, generator=g, device=dev).to(torch.bfloat16)
        gb = 2 * nbytes(xb) / 1e9
        torch_ms = []
        for th in (4, 32, 200):
            t = {}
            for mode in ("torch", "blocked", "chunked", "chunked", "blocked", "torch"):
                fn = (lambda: reference_copy(xb)) if mode == "torch" else \
                    (lambda: bw_copy(xb, th, mode))
                t.setdefault(mode, []).append(cuda_ms(fn, 10))
            t = {k: float(np.mean(v)) for k, v in t.items()}
            torch_ms.append(t["torch"])
            log(f"time bw copy B={batch} th={th}: blocked {t['blocked']:.4f} ms "
                f"({gb / t['blocked'] * 1e3:.0f} GB/s, {t['blocked'] / t['torch']:.3f} x "
                f"torch), chunked {t['chunked']:.4f} ms ({gb / t['chunked'] * 1e3:.0f} GB/s), "
                f"x * 0.5 {t['torch']:.4f} ms ({gb / t['torch'] * 1e3:.0f} GB/s)")
            if batch == 8 and th == 32:
                kernels["bw_probe"].update(max_abs_err=0.0, ms=t["blocked"],
                                           plain_ms=t["torch"], library_ms=t["torch"])
                set_bound(kernels["bw_probe"], 2 * nbytes(xb), 0)
        del xb
    del x
    torch.cuda.empty_cache()

    _build.reset_launch_counts()
    fused_kernel_probe.main(["--batch", "8", "--iters", "3"])
    dma_streams_probe.main(["--batch", "8"])
    bw_probe.main(["--batch", "8"])
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"probe tools launches at B=8: {counts}")
    for name in PROBE_KERNELS:
        kernels[name]["launches"] = counts[name]
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by its probe tool")


def train_cfg(fused: bool, dtype: str = "bfloat16"):
    cfg = flagship_cfg(fused, dtype)
    cfg.defrost()
    cfg.SOLVER.WARMUP_ITERS = 0      # a test setting: full LR from step 0
    cfg.freeze()
    return cfg


def train_batch(batch: int, seed: int, gt_pad: int = 100):
    """uint8 800x1344 images and gt_pad integer-pixel boxes per image, of
    which 5-30 are valid."""
    rs = np.random.RandomState(seed)
    x1 = rs.randint(0, 1344 - 16, (batch, gt_pad))
    y1 = rs.randint(0, 800 - 16, (batch, gt_pad))
    x2 = np.minimum(x1 + rs.randint(16, 400, (batch, gt_pad)), 1344)
    y2 = np.minimum(y1 + rs.randint(16, 400, (batch, gt_pad)), 800)
    n_valid = rs.randint(5, 31, batch)
    return {
        "image": rs.randint(0, 256, (batch, 800, 1344, 3)).astype(np.uint8),
        "gt_boxes": np.stack([x1, y1, x2, y2], -1).astype(np.float32),
        "gt_classes": rs.randint(0, 80, (batch, gt_pad)).astype(np.int32),
        "gt_valid": np.arange(gt_pad)[None, :] < n_valid[:, None],
    }


def phase_train(dev):
    """The FCOS train step at full width, entered as a trainer does:
    build_model, build_optimizer, make_train_step, step(batch)."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.models.layers import FrozenBatchNorm
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(7)
    weights = None
    models = {}
    for key, fused, dtype in (("fused", True, "bfloat16"), ("unfused", False, "bfloat16"),
                              ("fp32", False, "float32")):
        m = build_model(train_cfg(fused, dtype), device=dev, generator=gen)
        if weights is None:
            with torch.no_grad():
                for mod in m.modules():
                    if isinstance(mod, FrozenBatchNorm):
                        n = mod.scale.numel()
                        mod.scale.copy_(torch.rand(n, generator=gen) * 0.5 + 0.75)
                        mod.bias.copy_(torch.randn(n, generator=gen) * 0.05)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        models[key] = m

    # (b) one step's gradients, three models from the same weights
    names = ["backbone.bottom_up.res3_1.conv2.weight", "backbone.bottom_up.res4_1.conv2.weight",
             "backbone.bottom_up.res5_1.conv2.weight", "head.cls_tower0.weight"]
    small = train_batch(2, seed=8)
    grads = {}
    for key, m in models.items():
        build_optimizer(train_cfg(key == "fused"), m)     # applies FREEZE_AT
        _build.reset_launch_counts()
        total, _ = m.loss(small)
        total.backward()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        if key == "fused" and not (counts["fused_stem"] > 0 and counts["fused_bottleneck"] > 0):
            raise AssertionError(f"fused train forward launched {counts}")
        params = dict(m.named_parameters())
        grads[key] = {n: params[n].grad.detach().float().clone() for n in names}
        log(f"train grads {key}: total loss {float(total.detach()):.5f}")
        m.zero_grad(set_to_none=True)
    for n in names:
        gf, gu, g32 = grads["fused"][n], grads["unfused"][n], grads["fp32"][n]
        e_f, e_u = ratio(gf, g32), ratio(gu, g32)
        log(f"grad {n}: max|g| fused {float(gf.abs().max()):.3e}, err ratio vs fp32 "
            f"fused {e_f:.3e}, unfused bf16 {e_u:.3e} (fused <= {GRAD_FACTOR} x unfused)")
        if not (float(gf.abs().max()) > 0 and e_f <= GRAD_FACTOR * e_u):
            raise AssertionError(f"grad {n}: fused err {e_f}, unfused {e_u}")
    del models["fp32"], grads
    torch.cuda.empty_cache()

    # (a), (c), (d): steps on one batch of IMS_PER_BATCH images, the two
    # models in turns; each one's first turn is the TRAIN_STEPS + 1 steps
    # whose loss must fall
    batch_size = train_cfg(True).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=9)
    steps = {}
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused")
        steps[key] = make_train_step(models[key], build_optimizer(cfg, models[key]), cfg)
    for turn, key in enumerate(("fused", "unfused", "fused", "unfused")):
        first = turn < 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        totals, times, parts = [], [], []
        for i in range(TRAIN_STEPS + 1 if first else 4):
            t0 = time.perf_counter()
            metrics = steps[key](batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"train {key} step {i}: non-finite {metrics}")
            totals.append(metrics["total_loss"])
            parts.append(" ".join(f"{k.split('_')[0]} {metrics[k]:.3f}" for k in
                                  ("cls_loss", "reg_loss", "centerness_loss", "num_pos")))
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = times[2:] if first else times
        log(f"train {key} B={batch_size}: totals {[round(t, 4) for t in totals]}; "
            f"{np.mean(steady) * 1e3:.1f} ms/step, {batch_size / np.mean(steady):.2f} "
            f"img/s, peak {peak:.2f} GiB; launches {counts}")
        log(f"train {key}: first step {parts[0]}; last step {parts[-1]}")
        if key == "fused" and not (counts["fused_stem"] > 0 and counts["fused_bottleneck"] > 0):
            raise AssertionError(f"fused train steps launched {counts}")
        if first and not totals[-1] < totals[0]:
            raise AssertionError(f"train {key}: total {totals[-1]} after {TRAIN_STEPS} "
                                 f"steps is not below step 0's {totals[0]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA device", file=sys.stderr)
        return 2
    smi = card_line()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from slenderobjdet_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"from {_build.library_path()}")

    src = "slenderobjdet_torch/ops/csrc"
    kernels = {
        "nms": {"name": "nms", "route": "cuda", "source": f"{src}/nms.cu",
                "replaces": "slenderobjdet_tpu/ops/pallas_nms.py:29"},
        "fused_stem": {"name": "fused_stem", "route": "cuda",
                       "source": f"{src}/fused_stem.cu",
                       "replaces": "slenderobjdet_tpu/ops/fused_stem.py:111"},
        "fused_bottleneck": {"name": "fused_bottleneck", "route": "cuda",
                             "source": f"{src}/fused_bottleneck.cu",
                             "replaces": "slenderobjdet_tpu/ops/fused_bottleneck.py:55"},
        "fused_kernel_probe": {"name": "fused_kernel_probe", "route": "cuda",
                               "source": f"{src}/fused_bottleneck.cu",
                               "replaces": "tools/fused_kernel_probe.py:38"},
        "dma_streams_probe": {"name": "dma_streams_probe", "route": "cuda",
                              "source": f"{src}/dma_streams_probe.cu",
                              "replaces": "tools/dma_streams_probe.py:28"},
        "bw_probe": {"name": "bw_probe", "route": "cuda", "source": f"{src}/bw_probe.cu",
                     "replaces": "tools/pallas_bw_probe.py:37"},
    }
    failed = []

    def run(name, fn, *args):
        t = time.perf_counter()
        try:
            fn(*args)
            log(f"phase {name}: ok ({time.perf_counter() - t:.1f} s)")
            return True
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            log(f"phase {name}: FAILED")
            failed.append(name)
            return False

    run("nms", phase_nms, kernels, dev)
    run("stem", phase_stem, kernels, dev)
    run("bottleneck", phase_bottleneck, kernels, dev)
    torch.cuda.empty_cache()
    models = []
    if run("build", lambda: models.extend(build_models(dev))):
        run("main_path", phase_main_path, kernels, dev, *models)
        del models[2]
        torch.cuda.empty_cache()
        run("throughput", phase_throughput, *models)
    models.clear()
    torch.cuda.empty_cache()
    run("probes", phase_probes, kernels, dev)
    torch.cuda.empty_cache()
    run("train", phase_train, dev)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log_bounds(kernels)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
