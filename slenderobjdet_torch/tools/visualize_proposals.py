"""Draw saved RPN proposals with their source anchors beside the final
predictions and the ground truth (counterpart of
``tools/visualize_proposals.py``: the same flags). Proposals come from the
``.pkl`` of ``eval_and_save_proposals``, thresholded by
sigmoid(objectness); panels are written as PNG.

    python -m slenderobjdet_torch.tools.visualize_proposals --proposal box_proposals.pkl \\
        --result coco_instances_results.json --gt-json instances.json \\
        --image-root images/ --output vis_props [--conf-threshold 0.5] \\
        [--proposal-threshold 0.5] [--max-images 20]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import defaultdict
from typing import List, Optional

import numpy as np

from ..evaluation.coco_api import COCO
from ..utils.visualizer import Visualizer
from ._common import read_bgr, write_png
from .visualize_json_results import xyxy


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--proposal", required=True, help="box_proposals.pkl")
    ap.add_argument("--result", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--conf-threshold", type=float, default=0.5)
    ap.add_argument("--proposal-threshold", type=float, default=0.5,
                    help="sigmoid(objectness) threshold for drawn proposals")
    ap.add_argument("--max-images", type=int, default=20)
    args = ap.parse_args(argv)
    with open(args.proposal, "rb") as f:
        data = pickle.load(f)
    props = {img_id: (np.asarray(b), None if a is None else np.asarray(a), np.asarray(lg))
             for img_id, b, a, lg in zip(data["ids"], data["boxes"], data["anchors"],
                                         data["objectness_logits"])}
    with open(args.result) as f:
        preds = json.load(f)
    pred_by_image = defaultdict(list)
    for p in preds:
        pred_by_image[p["image_id"]].append(p)
    coco = COCO(args.gt_json)
    written = []
    for img_id, info in sorted(coco.imgs.items()):
        if len(written) >= args.max_images or img_id not in props:
            continue
        img = read_bgr(os.path.join(args.image_root, info["file_name"]))
        if img is None:
            continue
        boxes, anchors, logits = props[img_id]
        keep = 1.0 / (1.0 + np.exp(-logits)) > args.proposal_threshold
        vis_prop = Visualizer(img)
        vis_prop.draw_proposals(boxes[keep])
        if anchors is not None:
            vis_prop.draw_anchors(anchors[keep])
        dets = [p for p in pred_by_image.get(img_id, []) if p["score"] > args.conf_threshold]
        vis_pred = Visualizer(img)
        if dets:
            vis_pred.draw_boxes(xyxy([p["bbox"] for p in dets]),
                                scores=[p["score"] for p in dets])
        vis_gt = Visualizer(img)
        anns = coco.imgToAnns.get(img_id, [])
        if anns:
            vis_gt.draw_boxes(xyxy([a["bbox"] for a in anns]))
        concat = np.concatenate([vis_prop.get(), vis_pred.get(), vis_gt.get()], axis=1)
        written.append(write_png(os.path.join(args.output, info["file_name"]), concat))
    print(f"wrote {len(written)} proposal|pred|gt panels to {args.output}")
    return written


if __name__ == "__main__":
    main()
