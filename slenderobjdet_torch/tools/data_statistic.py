"""A dataset's slenderness (counterpart of ``tools/data_statistic.py``: the
same flags and lines): the ratio's mean and median and the instances in
each ratio bucket of a COCO json.

    python -m slenderobjdet_torch.tools.data_statistic --gt-json instances_val2017.json

Host only: no model and no card.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..evaluation.coco_api import COCO

BUCKETS = [(0, 1 / 5), (1 / 5, 1 / 3), (1 / 3, 3), (3, 5), (5, 1e5)]
NAMES = ["XS(0-1/5)", "S(1/5-1/3)", "M(1/3-3)", "L(3-5)", "XL(5-INF)"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-json", required=True)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns {bucket name: instances} as printed."""
    args = parse_args(argv)
    coco = COCO(args.gt_json)
    ratios = np.array([a["ratio"] for a in coco.anns.values() if not a.get("iscrowd", 0)])
    print(f"{len(ratios)} instances, {len(coco.imgs)} images")
    print(f"ratio: mean {ratios.mean():.3f} median {np.median(ratios):.3f}")
    total = len(ratios)
    counts = {}
    for (lo, hi), name in zip(BUCKETS, NAMES):
        n = counts[name] = int(((ratios >= lo) & (ratios < hi)).sum())
        print(f"  {name:>12s}: {n:7d} ({100 * n / total:5.1f}%)")
    return counts


if __name__ == "__main__":
    main()
