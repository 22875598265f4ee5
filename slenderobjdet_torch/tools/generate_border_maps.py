"""Pre-render the border, centre and size maps of a dataset's polygons
(counterpart of ``tools/generate_border_maps.py``: the same flags and
``.npz`` files, one an image, ``<image id:012d>.npz`` with ``center``,
``border`` and ``sizes``), by ``structures/borders.py:BorderMasks`` (no
cv2; its C renderer where it builds).

    python -m slenderobjdet_torch.tools.generate_border_maps --gt-json instances.json \\
        --out-dir border_maps [--max-images 100]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..evaluation.coco_api import COCO
from ..structures.borders import BorderMasks


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--max-images", type=int, default=100)
    args = ap.parse_args(argv)
    coco = COCO(args.gt_json)
    os.makedirs(args.out_dir, exist_ok=True)
    done = 0
    for img_id, info in sorted(coco.imgs.items()):
        anns = [a for a in coco.imgToAnns.get(img_id, []) if not a.get("iscrowd", 0)]
        polys = [[np.asarray(p, np.float64) for p in a["segmentation"] if len(p) >= 6]
                 for a in anns if isinstance(a.get("segmentation"), list)]
        polys = [p for p in polys if p]
        if not polys:
            continue
        masks = BorderMasks(polys)
        hw = (info["height"], info["width"])
        center = masks.center_masks(hw, standard="gaussian", sigma=0.5)
        border, sizes = masks.border_masks(hw)
        np.savez_compressed(os.path.join(args.out_dir, f"{img_id:012d}.npz"),
                            center=center, border=border, sizes=sizes)
        done += 1
        if done >= args.max_images:
            break
    print(f"rendered maps for {done} images into {args.out_dir}")
    return done


if __name__ == "__main__":
    main()
