"""Staged device-time profile of Faster R-CNN (``ProposalVisibleRCNN``)
predict: backbone+RPN-head forward / +RPN proposal selection (top-k + NMS) /
+ROIAlign pooling / +box head / full predict (counterpart of
``tools/rcnn_profile.py``: the same flags, sizes and lines).

    python -m slenderobjdet_torch.tools.rcnn_profile [--batch 8] [--reps 8]
        [--all-level-pool] [--device cuda|cpu]

``configs/faster/faster_rcnn_R_50_FPN_1x.yaml`` (bf16, the fused flags off
as the yaml leaves them) with weights drawn from seed 0, on B uint8 zero
images of 800 x 1344. Each stage runs the ones before it: the network
(``RCNNModule.forward``); the proposals (``RPN.proposals``: per-level top-k,
decode, clip, one launch of the NMS kernel over (image, level) rows); the
pooled features (``StandardROIHeads.pool``: the single-gather pooler, or
with ``--all-level-pool`` every level pooled and selected); the box head
(``ROIBoxModule``); and ``ProposalVisibleRCNN.predict``, whose class-aware
NMS over the box head's candidates is the NMS kernel's second launch a call.
(The JAX script's ``--all-level-pool`` reaches the JAX package's training
pooler unless ``SLENDER_TRAIN_POOLER=alllevel`` is set; its forward is the
single gather. The port has one pooler for both and times the all-level
path the flag names.) Each stage is called once and then ``--reps`` times
back to back (``tools/_profile.py``); the first line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import torch

from ._profile import (StageTimer, add_device_arg, device_line, device_of, load_cfg,
                       predict_batch, seeded_model)

CONFIG = "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"
OVERRIDES: List[str] = []           # KEY VALUE pairs over the yaml
HW = (800, 1344)


def stages(model, batch, fused_pool: bool = True) -> Dict[str, Callable[[], object]]:
    """The timed stages, in the JAX script's order; each returns what the
    next one starts from."""
    img = batch["image"]
    H, W = img.shape[1:3]
    image_sizes = torch.tensor((H, W), device=img.device).expand(img.shape[0], 2)

    def fwd():
        return model(img)

    def props():
        logits_l, deltas_l, roi_feats = fwd()
        anchors, counts = model.rpn_anchors((H, W))
        proposals, prop_scores, prop_valid = model.rpn.proposals(
            anchors, counts, torch.cat(logits_l, dim=1), torch.cat(deltas_l, dim=1),
            image_sizes, train=False)
        return proposals, prop_scores, prop_valid, roi_feats

    def pooled_feats():
        proposals, _, prop_valid, roi_feats = props()
        return model.roi_heads.pool(roi_feats, proposals, fused=fused_pool), proposals, prop_valid

    def box_head():
        return model.roi_box(pooled_feats()[0])

    return {"backbone+RPN fwd": fwd, "+RPN proposals": props, "+ROIAlign pool": pooled_feats,
            "+box head": box_head, "full predict": lambda: model.predict(batch)}


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--all-level-pool", action="store_true",
                    help="profile the pool-every-level path instead of the "
                         "fused single-gather inference pooler")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B = args.batch
    H, W = HW

    model = seeded_model(load_cfg(CONFIG, OVERRIDES), dev)
    timer = StageTimer(dev, args.reps)
    t_fwd, t_props, t_pool, t_head, t_full = (
        timer(name, fn) for name, fn in
        stages(model, predict_batch(B, HW, dev), not args.all_level_pool).items())

    print(f"B={B} {H}x{W}:")
    print(f"  backbone+RPN fwd  {t_fwd:8.2f} ms  ({t_fwd / B:.2f} ms/img)")
    print(f"  +RPN proposals    {t_props:8.2f} ms  (+{(t_props - t_fwd) / B:.2f} ms/img)")
    print(f"  +ROIAlign pool    {t_pool:8.2f} ms  (+{(t_pool - t_props) / B:.2f} ms/img)")
    print(f"  +box head         {t_head:8.2f} ms  (+{(t_head - t_pool) / B:.2f} ms/img)")
    print(f"  full predict      {t_full:8.2f} ms  (+{(t_full - t_head) / B:.2f} ms/img final NMS)")
    print(f"  total             {t_full / B:.2f} ms/img ({B / t_full * 1e3:.1f} img/s)")
    return timer.result()


if __name__ == "__main__":
    main()
