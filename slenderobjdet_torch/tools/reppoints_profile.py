"""Staged device-time profile of RepPoints predict: backbone+FPN / full head
forward / full predict, plus the shared deform gather in isolation on the
same shapes (counterpart of ``tools/reppoints_profile.py``: the same flags,
sizes and lines).

    python -m slenderobjdet_torch.tools.reppoints_profile [--batch 8] [--reps 8]
        [--full] [--device cuda|cpu]

``configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml`` (bf16, the fused
flags off as the yaml leaves them) with weights drawn from seed 0, on B
uint8 zero images of 800 x 1344: the trunk and FPN
(``RepPointsModule.features``), the network (``RepPointsModule.forward``)
and, with ``--full``, ``RepPointsDetector.predict`` (one launch of the NMS
kernel a call; without it the row repeats the head's time, as the JAX
script's does). Then ``deform_sample_batched`` alone at the P3 gather of the
concatenated towers, (B, 100, 168, 512) bf16 with offsets ``randn * 3``
drawn in numpy from seed 0. Each stage is called once and then ``--reps``
times back to back (``tools/_profile.py``); the first line names the card
and its power limit.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..ops.deform_conv import deform_sample_batched
from ._profile import (StageTimer, add_device_arg, device_line, device_of, load_cfg,
                       predict_batch, seeded_model)

CONFIG = "configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml"
OVERRIDES: List[str] = []           # KEY VALUE pairs over the yaml
HW = (800, 1344)
GATHER = (100, 168, 512)            # P3's h, w and the two towers' channels
KERNEL_POINTS = 9


def gather_inputs(batch: int, h: int, w: int, c: int, seed: int = 0):
    """The gather's features (B, h, w, c) uniform in [0, 1) and offsets (B,
    h, w, 9, 2) ``randn * 3``, float32 numpy, drawn as the JAX script draws
    them."""
    r = np.random.RandomState(seed)
    cat = r.rand(batch, h, w, c).astype(np.float32)
    off = (r.randn(batch, h, w, KERNEL_POINTS, 2) * 3).astype(np.float32)
    return cat, off


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="also time full predict")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B = args.batch
    H, W = HW

    model = seeded_model(load_cfg(CONFIG, OVERRIDES), dev)
    batch = predict_batch(B, HW, dev)
    img = batch["image"]
    timer = StageTimer(dev, args.reps)
    t_bb = timer("backbone+FPN", lambda: model.features(img))
    t_head = timer("full head forward", lambda: model(img))
    t_full = timer("full predict", lambda: model.predict(batch)) if args.full else t_head
    del model

    h3, w3, c2 = GATHER
    cat, off = gather_inputs(B, h3, w3, c2)
    cat = torch.from_numpy(cat).to(dev, torch.bfloat16)
    off = torch.from_numpy(off).to(dev)
    t_gather = timer("P3 2C gather alone", lambda: deform_sample_batched(cat, off))

    print(f"B={B} {H}x{W}:")
    print(f"  backbone+FPN      {t_bb:8.2f} ms  ({t_bb / B:.2f} ms/img)")
    print(f"  full head forward {t_head:8.2f} ms  (+{(t_head - t_bb) / B:.2f} ms/img head)")
    print(f"  full predict      {t_full:8.2f} ms  (+{(t_full - t_head) / B:.2f} ms/img post)")
    print(f"  P3 2C gather alone {t_gather:7.2f} ms  ({t_gather / B:.2f} ms/img)")
    return timer.result()


if __name__ == "__main__":
    main()
