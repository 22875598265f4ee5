"""Draw detections coloured by slenderness group, and the ground truth's
filled masks, the paper's figure style (counterpart of
``tools/visualize_slender_results.py``: the same flags). Writes
``<image id:012d>.png`` and ``<image id:012d>_gt.png``.

    python -m slenderobjdet_torch.tools.visualize_slender_results \\
        --results output/coco_instances_results.json --gt-json instances_val2017.json \\
        --image-root val2017 --out-dir vis [--score-thresh 0.3] [--max-images 20]
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
from .visualize_json_results import xyxy

WHITE = (255, 255, 255)


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--out-dir", default="vis")
    ap.add_argument("--score-thresh", type=float, default=0.3)
    ap.add_argument("--max-images", type=int, default=20)
    args = ap.parse_args(argv)
    coco = COCO(args.gt_json)
    names = {c["id"]: c["name"] for c in coco.cats.values()}
    with open(args.results) as f:
        dets = json.load(f)
    by_image = defaultdict(list)
    for d in dets:
        if d["score"] >= args.score_thresh:
            by_image[d["image_id"]].append(d)
    written = []
    for i, (img_id, ds) in enumerate(sorted(by_image.items())):
        if i >= args.max_images:
            break
        info = coco.imgs[img_id]
        path = os.path.join(args.image_root, info["file_name"])
        img = read_bgr(path)
        if img is None:
            continue
        boxes = xyxy([d["bbox"] for d in ds], np.float64)
        out = Visualizer(img).draw_boxes(boxes, scores=[d["score"] for d in ds])
        for (x1, y1, _, _), d in zip(boxes.astype(int), ds):
            put_label(out, names.get(d["category_id"], str(d["category_id"])), x1, y1, WHITE,
                      lift=12)
        written.append(write_png(os.path.join(args.out_dir, f"{img_id:012d}.png"), out))
        anns = coco.loadAnns(coco.getAnnIds(imgIds=[img_id]))
        polys = [a.get("segmentation") or [] for a in anns]
        if any(len(p) for p in polys):
            gt_boxes = xyxy([a["bbox"] for a in anns], np.float64)
            gout = Visualizer(read_bgr(path)).draw_instances(boxes=gt_boxes, masks=polys)
            for (x1, y1, _, _), a in zip(gt_boxes.astype(int), anns):
                put_label(gout, names.get(a["category_id"], str(a["category_id"])), x1, y1,
                          WHITE, lift=12)
            written.append(write_png(os.path.join(args.out_dir, f"{img_id:012d}_gt.png"), gout))
    print("wrote visualizations to", args.out_dir)
    return written


if __name__ == "__main__":
    main()
