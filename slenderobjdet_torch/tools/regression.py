"""Linear regression of AP against aspect ratio, the paper's ratio-vs-AP
diagnosis (counterpart of ``tools/regression.py``: the same flags, modes and
lines).

- per category (with ``--coco-json``): x is each category's mean or std of
  the gt annotations' ``ratio``, y its AP from the evaluator's
  ``AP-per-category``;
- otherwise the three populated ratio buckets' APs against log ratio.

    python -m slenderobjdet_torch.tools.regression \\
        --metrics output/evaluate_metrics.json \\
        [--coco-json instances.json] [--stat mean|std]

Host only (scipy): no model and no card.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np

BUCKETS = ["AP-0-1/5", "AP-1/5-1/3", "AP-1/3-3"]
BUCKET_X = [0.1, 0.27, 1.0]  # representative ratios


def regression(x, y) -> str:
    import scipy.stats as st

    slope, intercept, r_value, p_value, std_err = st.linregress(x, y)
    return (f"slope    : {slope}\nintercept: {intercept}\n"
            f"r_value  : {r_value}")


def category_ratio_stats(coco_json: str, stat: str = "mean"):
    """{category name: mean or std of its annotations' ``ratio``}."""
    from ..evaluation.coco_api import COCO

    api = COCO(coco_json)
    out = {}
    for cat_id in api.getCatIds():
        anns = api.loadAnns(api.getAnnIds(catIds=[cat_id]))
        ratios = [a["ratio"] for a in anns if a.get("ratio") is not None]
        if not ratios:
            continue
        name = api.loadCats([cat_id])[0]["name"]
        out[name] = float(np.mean(ratios)) if stat == "mean" else float(np.std(ratios))
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--metrics", required=True,
                    help="evaluate_metrics.json from COCOEvaluator")
    ap.add_argument("--coco-json", default=None,
                    help="gt json: enables the per-category regression")
    ap.add_argument("--stat", default="mean", choices=["mean", "std"],
                    help="per-category ratio statistic used as x")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the regressed points as printed: {"x": [...], "y": [...]}
    and, per category, their names."""
    args = parse_args(argv)
    with open(args.metrics) as f:
        m = json.load(f)["bbox"]

    per_cat = m.get("AP-per-category")
    if args.coco_json and per_cat:
        stats = category_ratio_stats(args.coco_json, args.stat)
        xs, ys, names = [], [], []
        for name, ratio in sorted(stats.items()):
            apv = per_cat.get(name)
            if apv is not None and np.isfinite(apv):
                xs.append(ratio)
                ys.append(apv)
                names.append(name)
        print(f"{len(xs)} categories; x = {args.stat} slenderness, y = AP")
        for n, x, y in zip(names, xs, ys):
            print(f"  {n:24s} ratio={x:.4f}  AP={y:.2f}")
        if len(xs) >= 2:
            print(regression(np.asarray(xs), np.asarray(ys)))
        else:
            print("not enough categories for a regression")
        return {"x": xs, "y": ys, "names": names}

    xs, ys = [], []
    for b, x in zip(BUCKETS, BUCKET_X):
        v = m.get(b)
        if v is not None and v >= 0:
            xs.append(x)
            ys.append(v)
    print({b: m.get(b) for b in BUCKETS})
    if len(xs) >= 2:
        print(regression(np.log(xs), ys))
    else:
        print("not enough populated buckets for a regression")
    return {"x": xs, "y": ys}


if __name__ == "__main__":
    main()
