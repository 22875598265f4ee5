"""Per-class instance counts and slenderness (counterpart of
``tools/coco_class_info.py``: the same flags and table).

    python -m slenderobjdet_torch.tools.coco_class_info \\
        --gt-json instances_val2017.json [--sort-by slender|count|name]

Host only: no model and no card.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import List, Optional

import numpy as np

from ..evaluation.coco_api import COCO


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--sort-by", default="slender", choices=["slender", "count", "name"])
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    """Returns the rows as printed: (name, count, median ratio, % slender)."""
    args = parse_args(argv)
    coco = COCO(args.gt_json)
    per_class = defaultdict(list)
    for a in coco.anns.values():
        if not a.get("iscrowd", 0):
            per_class[a["category_id"]].append(a["ratio"])

    rows = []
    for cid, ratios in per_class.items():
        r = np.array(ratios)
        rows.append((coco.cats[cid]["name"], len(r), float(np.median(r)),
                     float((r < 1 / 3).mean() * 100)))
    key = {"slender": lambda x: -x[3], "count": lambda x: -x[1],
           "name": lambda x: x[0]}[args.sort_by]
    rows.sort(key=key)
    print(f"{'class':>20s} {'count':>7s} {'med-ratio':>10s} {'%slender':>9s}")
    for name, n, med, slender in rows:
        print(f"{name:>20s} {n:7d} {med:10.3f} {slender:8.1f}%")
    return rows


if __name__ == "__main__":
    main()
