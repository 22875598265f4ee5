"""Staged device-time profile of CornerNet predict: hourglass backbone /
+corner pools and heads / full predict (+decode, pairing, NMS), and with
``--stages`` a bisection of the decode (counterpart of
``tools/corner_profile.py``: the same flags, sizes and lines).

    python -m slenderobjdet_torch.tools.corner_profile [--batch 4] [--reps 8]
        [--size 512 768] [--stages] [--device cuda|cpu]

``configs/corner/corner_net_hourglass.yaml`` (Hourglass-104, bf16) with
weights drawn from seed 0, on B uint8 zero images of ``--size``. Stages: the
trunk; the trunk and the last stack's TL and BR heads (``CornerNet.forward``
with ``stacks=[last]``: two launches of the corner-pool kernel a call);
``CornerNet.predict`` (those, then the decode and one launch of the NMS
kernel). The JAX stage applies the whole module, every stack's heads; its
jitted predict drops the first stack's heads as dead code, and eager PyTorch
drops nothing, so here the stage runs the heads predict runs and
``full predict`` minus it is the decode.

``--stages`` times ``corner_decode`` cut after the corner top-k, after the
pairing and after the NMS (the NMS kernel), each on the heads' outputs. It
replicates the JAX script's decode closure, which deliberately copies the
flat H*W*C top-k that predict used before its ``pair_top_k`` (the before
side of that A/B), not predict's path. Each stage is called once and then
``--reps`` times back to back (``tools/_profile.py``); the first line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..models.meta_arch.corner_net import STRIDE, TOPK_CORNERS
from ..ops.nms import cuda_batched_nms
from ._profile import (StageTimer, add_device_arg, device_line, device_of, load_cfg,
                       predict_batch, seeded_model)

CONFIG = "configs/corner/corner_net_hourglass.yaml"
OVERRIDES: List[str] = []           # KEY VALUE pairs over the yaml
DECODE_STAGES = ("topk", "pair", "nms")
PAIR_THRESH = 0.05
NMS_THRESH = 0.5


def flat_corners(heat, tag, off, k: int = TOPK_CORNERS, stride: int = STRIDE):
    """One side's top ``k`` corners by a flat top-k over H * W * C after the
    3x3 max-pool NMS of the sigmoid heatmap: scores, classes (int32), x, y
    and tags, (B, k) each."""
    B, H, W, C = heat.shape
    p = torch.sigmoid(heat)
    pooled = F.max_pool2d(p.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    p = torch.where(p == pooled, p, 0.0)
    scores, idx = torch.topk(p.reshape(B, H * W * C), k, dim=1)
    cls = (idx % C).to(torch.int32)
    loc = idx // C
    iy = (loc // W).float()
    ix = (loc % W).float()
    t = torch.gather(tag.reshape(B, H * W), 1, loc)
    o = torch.gather(off.reshape(B, H * W, 2), 1, loc[..., None].expand(-1, -1, 2))
    return scores, cls, (ix + o[..., 0]) * stride, (iy + o[..., 1]) * stride, t


def corner_decode(tl, br, upto: str, max_dets: int, k: int = TOPK_CORNERS):
    """The decode of the last stack's heads ``tl``, ``br`` ((heat, tag,
    offset) each), cut after ``upto``:

    - ``topk``: both sides' ``flat_corners``;
    - ``pair``: every TL x BR pair of one class with the BR right of and
      below the TL and tags closer than 0.5, scored by the mean of the two,
      its top ``min(4 * max_dets, k * k)``: boxes (B, N, 4), scores,
      classes and the 0.05 gate;
    - ``nms``: class-aware NMS at 0.5 to ``max_dets`` (``cuda_batched_nms``):
      the kept boxes, scores, classes and validity."""
    ts, tc, tx, ty, ttag = flat_corners(*tl, k=k)
    bs, bc, bx, by, btag = flat_corners(*br, k=k)
    if upto == "topk":
        return ts, tc, tx, ty, ttag, bs, bc, bx, by, btag

    B = ts.shape[0]
    score = (ts[:, :, None] + bs[:, None, :]) / 2
    valid = ((tc[:, :, None] == bc[:, None, :])
             & (bx[:, None, :] > tx[:, :, None]) & (by[:, None, :] > ty[:, :, None])
             & (torch.abs(ttag[:, :, None] - btag[:, None, :]) < 0.5))
    score = torch.where(valid, score, 0.0)
    top, idx = torch.topk(score.reshape(B, k * k), min(max_dets * 4, k * k), dim=1)
    ti, bi = idx // k, idx % k
    boxes = torch.stack([torch.gather(tx, 1, ti), torch.gather(ty, 1, ti),
                         torch.gather(bx, 1, bi), torch.gather(by, 1, bi)], -1)
    classes = torch.gather(tc, 1, ti)
    det_valid = top > PAIR_THRESH
    if upto == "pair":
        return boxes, top, classes, det_valid

    keep_idx, keep_valid = cuda_batched_nms(boxes, top, classes, NMS_THRESH, max_dets,
                                            valid=det_valid)
    keep = keep_idx.long()
    return (torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
            torch.gather(top, 1, keep), torch.gather(classes, 1, keep), keep_valid)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(512, 768))
    ap.add_argument("--stages", action="store_true",
                    help="bisect the decode (flat-top_k replica stages)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B = args.batch
    H, W = args.size

    model = seeded_model(load_cfg(CONFIG, OVERRIDES), dev)
    batch = predict_batch(B, (H, W), dev, scale=1.0, orig_size=(H, W))
    img = batch["image"]
    last = [len(model.in_features) - 1]

    def backbone_only():
        x = (img.float() - model.pixel_mean) / model.pixel_std
        return model.backbone(x.to(model.dtype).permute(0, 3, 1, 2))

    def heads():
        return model(img, stacks=last)[0]

    timer = StageTimer(dev, args.reps)
    t_bb = timer("hourglass backbone", backbone_only)
    t_fwd = timer("+pools/heads", heads)
    t_full = timer("full predict", lambda: model.predict(batch))

    if args.stages:
        t_topk, t_pair, t_nms = (
            timer(f"decode {upto}", lambda: corner_decode(*heads(), upto, model.max_dets))
            for upto in DECODE_STAGES)
        print(f"  decode stages (vs fwd {t_fwd:.2f} ms; each stage runs the heads"
              " again, and eager PyTorch drops no work: cross-check against the"
              " full-predict delta. NOTE: '+corner topk' replicates the PRE-round-3"
              " flat H*W*C top-k, NOT current predict's pair_top_k — it is the"
              " before side of that A/B; 'full predict' times the real path):")
        print(f"    +corner topk   {t_topk - t_fwd:8.2f} ms/batch")
        print(f"    +pairing       {t_pair - t_topk:8.2f} ms/batch")
        print(f"    +NMS           {t_nms - t_pair:8.2f} ms/batch")

    print(f"B={B} {H}x{W}:")
    print(f"  hourglass backbone {t_bb:8.2f} ms  ({t_bb / B:.2f} ms/img)")
    print(f"  +pools/heads       {t_fwd:8.2f} ms  (+{(t_fwd - t_bb) / B:.2f} ms/img)")
    print(f"  full predict       {t_full:8.2f} ms  (+{(t_full - t_fwd) / B:.2f} ms/img decode)")
    print(f"  total              {t_full / B:.2f} ms/img ({B / t_full * 1e3:.1f} img/s)")
    return timer.result()


if __name__ == "__main__":
    main()
