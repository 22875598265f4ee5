"""AR by aspect-ratio and area bucket from saved predictions (counterpart of
``tools/ar_result.py``: the same flags and lines): the COCO results json
greedily matched to the ground truth, the recall matrix printed.

    python -m slenderobjdet_torch.tools.ar_result \\
        --results output/coco_instances_results.json \\
        --gt-json instances_val2017.json [--limit 100]

Host only: no model and no card.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import List, Optional

from ..evaluation.ar_recall import AREAS, ASPECT_RATIOS, evaluate_predictions_ar
from ..evaluation.coco_api import COCO


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--limit", type=int, default=100)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns ``evaluate_predictions_ar``'s statistics."""
    args = parse_args(argv)
    coco = COCO(args.gt_json)
    with open(args.results) as f:
        dets = json.load(f)

    by_image = defaultdict(list)
    for d in dets:
        by_image[d["image_id"]].append(d)
    predictions = [{"image_id": k, "instances": sorted(v, key=lambda x: -x["score"])}
                   for k, v in by_image.items()]
    id_map = {v: i for i, v in enumerate(sorted(coco.getCatIds()))}

    stats = evaluate_predictions_ar(predictions, coco, id_map, limit=args.limit)
    recalls = stats["recalls"]
    print(f"AR@{args.limit}: {stats['ar'] * 100:.2f}  "
          f"mAR@{args.limit}: {stats['mar'] * 100:.2f}")
    print("\nby aspect ratio (class-agnostic):")
    for i, key in enumerate(ASPECT_RATIOS):
        print(f"  {key:>12s}: AR {recalls[:, -1, i, 0].mean() * 100:6.2f}")
    print("by area (class-agnostic):")
    for i, key in enumerate(AREAS):
        print(f"  {key:>12s}: AR {recalls[:, -1, 0, i].mean() * 100:6.2f}")
    return stats


if __name__ == "__main__":
    main()
