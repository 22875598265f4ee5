"""Re-evaluate a saved prediction file offline (counterpart of
``tools/result_statistic.py``: the same flags, table and ``.pkl``): load the
predictions, run the slender ``COCOEvaluator`` over them without a model,
print the metrics and pickle them next to the prediction file.

    python -m slenderobjdet_torch.tools.result_statistic \\
        --prediction coco_instances_results.json --gt-json instances.json \\
        [--out metrics.pkl]

Host only: no model and no card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import defaultdict
from typing import List, Optional

import numpy as np

DATASET = "_result_statistic"
SCALARS = (int, float, np.floating, np.integer)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prediction", required=True,
                    help="coco_instances_results.json from COCOEvaluator")
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--out", default="",
                    help="default: <prediction stem>.pkl next to it")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the evaluator's results, as pickled."""
    from ..data import DatasetCatalog
    from ..data.datasets import register_coco_instances
    from ..evaluation import COCOEvaluator

    args = parse_args(argv)
    if DATASET in DatasetCatalog:
        DatasetCatalog.remove(DATASET)
    register_coco_instances(DATASET, args.gt_json, image_root="")

    out_dir = os.path.dirname(os.path.abspath(args.prediction))
    evaluator = COCOEvaluator(DATASET, output_dir=None)
    evaluator.reset()
    with open(args.prediction) as f:
        preds = json.load(f)
    by_image = defaultdict(list)
    for p in preds:
        by_image[p["image_id"]].append(p)

    # the evaluator's fixed-shape process() interface, one image a call
    id_map = evaluator._dataset_id_to_contiguous
    for img_id, insts in sorted(by_image.items()):
        insts = sorted(insts, key=lambda d: -d["score"])
        boxes = np.array([i["bbox"] for i in insts], np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        outputs = {
            "boxes": boxes[None],
            "scores": np.array([[i["score"] for i in insts]], np.float32),
            "classes": np.array([[id_map[i["category_id"]] for i in insts]], np.int32),
            "valid": np.ones((1, len(insts)), bool),
        }
        evaluator.process({"image_id": [img_id]}, outputs)

    results = evaluator.evaluate()
    for task, metrics in results.items():
        # scalars on one line, dict-valued entries (AP-per-category,
        # AP-ratios) below
        scalars = {k: v for k, v in metrics.items() if isinstance(v, SCALARS)}
        print(f"[{task}] " + ", ".join(f"{k}={v:.3f}" for k, v in scalars.items()))
        for k, v in metrics.items():
            if isinstance(v, dict):
                print(f"  {k}: " + ", ".join(
                    f"{kk}={vv:.3f}" for kk, vv in v.items() if isinstance(vv, SCALARS)))

    out = args.out or os.path.join(
        out_dir, os.path.splitext(os.path.basename(args.prediction))[0] + ".pkl")
    with open(out, "wb") as f:
        pickle.dump(results, f)
    print("saved metrics to", out)
    return results


if __name__ == "__main__":
    main()
