"""Draw COCO-format json predictions beside the ground truth, an image a
panel pair (counterpart of ``tools/visualize_json_results.py``: the same
flags). Images are read without cv2 where they are PNG; the panels are
written as PNG (``<output>/<file stem>.png``).

    python -m slenderobjdet_torch.tools.visualize_json_results \\
        --result coco_instances_results.json --gt-json instances.json \\
        --image-root images/ --output vis_out [--conf-threshold 0.5] [--max-images 20]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np

from ..evaluation.coco_api import COCO
from ..utils.visualizer import Visualizer, put_label
from ._common import read_bgr, write_png


def xyxy(bboxes, dtype=np.float32) -> np.ndarray:
    """COCO XYWH -> XYXY in ``dtype`` (float32 as the JAX tools build most;
    the truncation to pixels follows from it)."""
    b = np.array(bboxes, dtype).reshape(-1, 4)
    b[:, 2:] += b[:, :2]
    return b


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--result", required=True, help="json produced by COCOEvaluator")
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--conf-threshold", type=float, default=0.5)
    ap.add_argument("--max-images", type=int, default=20)
    args = ap.parse_args(argv)
    coco = COCO(args.gt_json)
    with open(args.result) as f:
        preds = json.load(f)
    by_image = defaultdict(list)
    for p in preds:
        by_image[p["image_id"]].append(p)
    names = {c["id"]: c.get("name", str(c["id"])) for c in coco.dataset.get("categories", [])}
    written = []
    for img_id, info in sorted(coco.imgs.items()):
        if len(written) >= args.max_images:
            break
        img = read_bgr(os.path.join(args.image_root, info["file_name"]))
        if img is None:
            continue
        dets = [p for p in by_image.get(img_id, []) if p["score"] > args.conf_threshold]
        vis_pred = Visualizer(img)
        if dets:
            vis_pred.draw_boxes(xyxy([p["bbox"] for p in dets]),
                                scores=[p["score"] for p in dets])
        vis_gt = Visualizer(img)
        anns = coco.imgToAnns.get(img_id, [])
        if anns:
            gtb = xyxy([a["bbox"] for a in anns])
            vis_gt.draw_boxes(gtb)
            for a, b in zip(anns, gtb):
                put_label(vis_gt.img, names.get(a["category_id"], "?"), int(b[0]), int(b[1]),
                          (255, 255, 255))
        concat = np.concatenate([vis_pred.get(), vis_gt.get()], axis=1)
        written.append(write_png(os.path.join(args.output, info["file_name"]), concat))
    print(f"wrote {len(written)} pred|gt comparisons to {args.output}")
    return written


if __name__ == "__main__":
    main()
