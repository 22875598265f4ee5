"""Bisection of FCOS inference postprocess cost (counterpart of
``tools/postprocess_probe.py``: the same flag, shapes and lines). Times the
two stages of the postprocess separately on representative shapes:

  cand:P3..P7  per-level candidate selection (``_fcos_level_candidates``:
               sigmoid, threshold, top-k over L*C, gathers, LTRB decode)
  nms          class-aware greedy NMS over the 5*1000 concatenated
               candidates of each image: ``cuda_batched_nms``, the route
               ``FCOS.predict`` takes (one launch of the NMS kernel a call)

    python -m slenderobjdet_torch.tools.postprocess_probe [--batch 32]
        [--device cuda|cpu]

The JAX script passes ``approx=True`` to the top-k (``approx_max_k``); the
port has no approximate top-k, so its candidates take the exact one. The
inputs are drawn in numpy from seed 0 (``level_inputs``, ``nms_inputs``):
logits ``randn * 2 - 4``, regressions ``|randn| * 50``, boxes of
``|randn| * 300`` with positive extents, uniform scores, valid above 0.3.
Each stage is called once and then 8 times back to back, as the JAX
script's 8 reps (``tools/_profile.py``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..models.meta_arch.fcos import _fcos_level_candidates
from ..ops.nms import cuda_batched_nms
from ._profile import StageTimer, add_device_arg, device_line, device_of

C = 80
K = 1000
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
REPS = 8
THRESH = 0.05
NMS_THRESH = 0.6
MAX_DETS = 100
VALID_ABOVE = 0.3


def level_inputs(batch: int, h: int, w: int, seed: int = 0):
    """One level's logits (B, L, C), regressions (B, L, 4), centerness (B, L)
    and locations (L, 2), float32 numpy."""
    rng = np.random.default_rng(seed)
    L = h * w
    logits = rng.standard_normal((batch, L, C), dtype=np.float32) * 2 - 4
    reg = np.abs(rng.standard_normal((batch, L, 4), dtype=np.float32)) * 50
    ctr = rng.standard_normal((batch, L), dtype=np.float32)
    locs = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2).astype(np.float32)
    return logits, reg, ctr, locs


def nms_inputs(batch: int, n: int, seed: int = 0):
    """Boxes (B, N, 4), scores (B, N), classes (B, N) int32 and valid (B, N)
    bool, numpy."""
    rng = np.random.default_rng(seed)
    bx = np.abs(rng.standard_normal((batch, n, 4), dtype=np.float32)) * 300
    bx[..., 2:] = bx[..., :2] + np.abs(bx[..., 2:]) + 1
    sc = rng.random((batch, n), dtype=np.float32)
    cl = rng.integers(0, C, (batch, n)).astype(np.int32)
    return bx, sc, cl, sc > VALID_ABOVE


def level_candidates(logits, reg, ctr, locs):
    """The ``cand`` stage of one level."""
    return _fcos_level_candidates(logits, reg, ctr, locs, THRESH, K)


def nms(boxes, scores, classes, valid):
    """The ``nms`` stage: keep indices (B, 100) and their validity."""
    return cuda_batched_nms(boxes, scores, classes, NMS_THRESH, MAX_DETS, valid=valid)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B = args.batch
    timer = StageTimer(dev, REPS)

    total = 0.0
    for (h, w) in LEVELS:
        a = [torch.from_numpy(x).to(dev) for x in level_inputs(B, h, w)]
        ms = timer(f"cand {h}x{w}", lambda: level_candidates(*a))
        total += ms
        print(f"cand {h:3d}x{w:3d} (L={h * w:6d}) {ms:7.2f} ms", flush=True)
        del a
    timer.ms["cand total"] = total
    print(f"cand total        {total:7.2f} ms")

    N = 5 * K
    a = [torch.from_numpy(x).to(dev) for x in nms_inputs(B, N)]
    ms = timer("nms", lambda: nms(*a))
    print(f"nms  (B,{N})x{MAX_DETS}   {ms:7.2f} ms", flush=True)
    return timer.result()


if __name__ == "__main__":
    main()
