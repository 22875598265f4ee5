"""Add oriented ``rbox`` fields to a COCO json from its segmentations
(counterpart of ``tools/mask_to_rbox.py``: the same flags and json), by
``structures/masks.py:rbox_from_polygon`` (cv2's ``minAreaRect`` transcribed,
no cv2 needed).

    python -m slenderobjdet_torch.tools.mask_to_rbox --gt-json instances_val2017.json \\
        --out rcoco_val2017.json
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from ..structures.masks import rbox_from_polygon


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.gt_json) as f:
        data = json.load(f)
    n_ok = 0
    for ann in data.get("annotations", []):
        segm = ann.get("segmentation")
        polys = ([p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                 if isinstance(segm, list) else [])
        if polys and not ann.get("iscrowd", 0):
            ann["rbox"] = rbox_from_polygon(polys)
            n_ok += 1
        else:
            x, y, w, h = ann["bbox"]
            ann["rbox"] = [x + w / 2, y + h / 2, w, h, 0.0]
    with open(args.out, "w") as f:
        json.dump(data, f)
    print(f"wrote {args.out} ({n_ok} oriented rboxes)")
    return n_ok


if __name__ == "__main__":
    main()
