"""Compare the IoU and top-k matchers on live anchors and ground truth
(counterpart of ``tools/compare_matchers.py``: the same flags and lines):
positive anchors a gt under each strategy, over a sample of the config's
first test set.

    python -m slenderobjdet_torch.tools.compare_matchers \\
        --config-file configs/faster/faster_rcnn_R_50_FPN_1x.yaml \\
        [--num-images 8] [--topk 10] [--device cpu]

Anchors and matchers run on the card unless ``--device cpu``; PNG images are
decoded without cv2.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ._common import PNGReadingMapper, load_cfg


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--num-images", type=int, default=8)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card, or an error without one) or cpu")
    return ap.parse_args(argv)


def resolve_device(device: Optional[str]) -> torch.device:
    """``device``, or the card where it is None; no card is an error, as in
    ``build_model``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                               "pass --device cpu to run on the CPU")
        device = "cuda"
    return torch.device(device)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns {"iou" | "topk": positive anchors a gt, image by image} and
    the images seen, as printed (means)."""
    from ..data import build_detection_test_loader
    from ..models.anchors import AnchorGeneratorSpec
    from ..models.matchers import iou_matcher, topk_matcher

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_cfg(args.config_file)
    strides = [2 ** int(f[1:]) for f in cfg.MODEL.RPN.IN_FEATURES]
    spec = AnchorGeneratorSpec(cfg, strides)
    loader = build_detection_test_loader(cfg, cfg.DATASETS.TEST[0], batch_size=1,
                                         mapper=PNGReadingMapper(cfg, is_train=False))
    thresholds, labels = cfg.MODEL.RPN.IOU_THRESHOLDS, cfg.MODEL.RPN.IOU_LABELS

    seen = 0
    stats = {"iou": [], "topk": []}
    for batch in loader:
        anchors = torch.as_tensor(spec.anchors(batch["image"].shape[1:3])[0], device=dev)
        gt = torch.as_tensor(np.asarray(batch["gt_boxes"][0]), device=dev)
        gv = torch.as_tensor(np.asarray(batch["gt_valid"][0]), device=dev)
        if not bool(gv.any()):
            continue
        _, lab_iou = iou_matcher(anchors, gt, gv, thresholds, labels)
        _, lab_topk = topk_matcher(anchors, gt, gv, thresholds, labels, k=args.topk)
        n_gt = int(gv.sum())
        stats["iou"].append(int((lab_iou == 1).sum()) / n_gt)
        stats["topk"].append(int((lab_topk == 1).sum()) / n_gt)
        seen += 1
        if seen >= args.num_images:
            break
    loader.close()
    for k, v in stats.items():
        print(f"{k:>5s} matcher: {np.mean(v):.2f} positive anchors per gt "
              f"(over {seen} images)")
    return dict(stats, images=seen)


if __name__ == "__main__":
    main()
