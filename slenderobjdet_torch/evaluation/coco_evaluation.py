"""COCO evaluator with slender (aspect-ratio) metrics.

Counterpart of the reference's `COCOEvaluator`
(`slender_det/evaluation/coco_evaluation.py:29-280`): gathers predictions,
converts them to COCO json format, runs the ratio-bucketed COCOeval
(slender_cocoeval.py) and the AR-by-ratio×area recall matrix (ar_recall.py),
and dumps machine-readable artifacts (coco_instances_results.json,
evaluate_metrics.json) for the tools layer.

Fixed-shape adaptation: `process` consumes the model's padded detection
arrays (boxes/scores/classes/valid), already fetched to the host by
`inference_on_dataset`, and strips padding by mask.

A copy of ``slenderobjdet_tpu/evaluation/coco_evaluation.py``, held equal to
it on fixed predictions by ``tests/test_torch_eval.py``. One process only:
the gather of predictions across processes comes with data-parallel
training. The per-category table is printed by a formatter of its own
(no ``tabulate``).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import MetadataCatalog
from .ar_recall import evaluate_predictions_ar
from .coco_api import COCO
from .slender_cocoeval import SlenderCOCOeval

STATS_NAMES = [
    "AP", "AP50", "AP75", "AP-0-1/5", "AP-1/5-1/3", "AP-1/3-3", "AP-3-5",
    "AP-5-INF", "AR@1", "AR@10", "AR@100", "AR-0-1/5", "AR-1/5-1/3",
    "AR-1/3-3", "AR-3-5", "AR-5-INF",
]


def _pipe_table(headers, rows) -> str:
    """A markdown pipe table; floats with three decimals, None as blank."""
    def cell(v):
        if v is None:
            return ""
        return f"{v:.3f}" if isinstance(v, float) else str(v)

    body = [[cell(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in body)) if body else len(h)
              for i, h in enumerate(headers)]

    def line(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"

    sep = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
    return "\n".join([line(headers), sep, *(line(r) for r in body)])


class COCOEvaluator:
    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._output_dir = output_dir
        json_file = self._metadata.get("json_file")
        self._coco_api = COCO(json_file)
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        if id_map is None:
            cat_ids = sorted(self._coco_api.getCatIds())
            id_map = {v: i for i, v in enumerate(cat_ids)}
        self._contiguous_to_dataset_id = {v: k for k, v in id_map.items()}
        self._dataset_id_to_contiguous = dict(id_map)
        self.reset()

    def reset(self):
        self._predictions: List[Dict] = []

    def process(self, batch: Dict, outputs: Dict):
        """batch: loader batch (numpy); outputs: model predict() results
        fetched to host (numpy), fixed-shape with validity masks."""
        boxes = np.asarray(outputs["boxes"])
        scores = np.asarray(outputs["scores"])
        classes = np.asarray(outputs["classes"])
        valid = np.asarray(outputs["valid"])
        batch_valid = batch.get("batch_valid", [True] * len(batch["image_id"]))

        for i, image_id in enumerate(batch["image_id"]):
            if not batch_valid[i]:
                continue
            instances = []
            for j in range(boxes.shape[1]):
                if not valid[i, j]:
                    continue
                cat = self._contiguous_to_dataset_id.get(int(classes[i, j]))
                if cat is None:
                    # a head wider than the dataset's category set (e.g. an
                    # 80-class model on a subset json) can emit classes with
                    # no dataset id; they can never match and are dropped
                    continue
                x1, y1, x2, y2 = boxes[i, j].tolist()
                instances.append(
                    {
                        "image_id": int(image_id),
                        "category_id": cat,
                        "bbox": [x1, y1, x2 - x1, y2 - y1],
                        "score": float(scores[i, j]),
                    }
                )
            # keep score-descending order for the AR matrix's greedy matching
            instances.sort(key=lambda d: -d["score"])
            self._predictions.append(
                {"image_id": int(image_id), "instances": instances}
            )

    def _gather_predictions(self) -> bool:
        """Cross-process prediction gather (reference `comm.gather`,
        `slender_det/evaluation/coco_evaluation.py:81-87`). Returns True on
        the process that should compute metrics. The port runs in one
        process, which holds every prediction already."""
        return True

    def evaluate(self) -> "OrderedDict[str, Dict[str, float]]":
        if not self._gather_predictions():
            return OrderedDict()
        results: OrderedDict = OrderedDict()
        coco_results = [
            inst for pred in self._predictions for inst in pred["instances"]
        ]

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(
                os.path.join(self._output_dir, "coco_instances_results.json"), "w"
            ) as f:
                json.dump(coco_results, f)

        # ----- ratio-bucketed AP (forked COCOeval semantics)
        if len(coco_results) == 0:
            results["bbox"] = {name: float("nan") for name in STATS_NAMES}
        else:
            coco_dt = self._coco_api.loadRes(coco_results)
            coco_eval = SlenderCOCOeval(self._coco_api, coco_dt, "bbox")
            img_ids = sorted({p["image_id"] for p in self._predictions})
            coco_eval.params.imgIds = img_ids
            coco_eval.evaluate()
            coco_eval.accumulate()
            stats = coco_eval.summarize()
            results["bbox"] = {
                name: float(stats[i] * 100) for i, name in enumerate(STATS_NAMES)
            }
            results["bbox"].update(self._per_category_results(coco_eval))

        # ----- AR recall matrix by ratio x area (diagnosis metrics)
        ar_stats = evaluate_predictions_ar(
            self._predictions,
            self._coco_api,
            self._dataset_id_to_contiguous,
            limit=100,
        )
        recalls = ar_stats["recalls"]
        ar_res: Dict[str, float] = {
            "AR@100": float(ar_stats["ar"] * 100),
            "mAR@100": float(ar_stats["mar"] * 100),
        }
        from .ar_recall import AREAS, ASPECT_RATIOS

        for i, key in enumerate(AREAS):
            ar_res[f"AR-{key}@100"] = float(recalls[:, -1, 0, i].mean() * 100)
            ar_res[f"mAR-{key}@100"] = float(recalls[:, :-1, 0, i].mean() * 100)
        for i, key in enumerate(ASPECT_RATIOS):
            ar_res[f"AR-{key}@100"] = float(recalls[:, -1, i, 0].mean() * 100)
            ar_res[f"mAR-{key}@100"] = float(recalls[:, :-1, i, 0].mean() * 100)
        results["ar"] = ar_res

        if self._output_dir:
            with open(
                os.path.join(self._output_dir, "evaluate_metrics.json"), "w"
            ) as f:
                json.dump(
                    {k: v for k, v in results.items()}, f, default=float
                )
        return results

    def _per_category_results(self, coco_eval) -> Dict[str, Dict]:
        """Per-category AP table + per-category per-ratio-bucket APs —
        counterpart of the reference `_derive_coco_results`
        (`slender_det/evaluation/coco_evaluation.py:204-236`): prints a
        tabulated per-category AP table and returns
        {"AP-per-category": {name: AP}, "AP-ratios": {"AP-"+name: [6 APs]}}
        where the 6 entries follow the forked COCOeval's ratio axis
        (all, 0-1/5, 1/5-1/3, 1/3-3, 3-5, 5-INF)."""
        import itertools

        cat_ids = list(coco_eval.params.catIds)
        cats = self._coco_api.loadCats(cat_ids)
        class_names = [c["name"] for c in cats]
        if len(class_names) <= 1:
            return {}

        # precision dims: (iou, recall, category, ratio range, max dets)
        precisions = np.asarray(coco_eval.eval["precision"])
        assert precisions.shape[2] == len(class_names)

        per_category = []
        per_category_ratios = []
        for idx, name in enumerate(class_names):
            p = precisions[:, :, idx, 0, -1]
            p = p[p > -1]
            ap = float(np.mean(p) * 100) if p.size else float("nan")
            per_category.append((name, ap))
            # per-ratio: mean over iou & recall per ratio-range column,
            # matching the reference's masked -1 semantics (mean over raw
            # values including -1 sentinel is what the reference computes;
            # we mask like the headline AP for a meaningful number)
            cols = []
            for a in range(precisions.shape[3]):
                pa = precisions[:, :, idx, a, -1]
                pa = pa[pa > -1]
                cols.append(float(np.mean(pa)) if pa.size else float("nan"))
            per_category_ratios.append((name, cols))

        n_cols = min(6, len(per_category) * 2)
        flat = list(itertools.chain(*per_category))
        rows = itertools.zip_longest(*[flat[i::n_cols] for i in range(n_cols)])
        print("Per-category bbox AP: \n" + _pipe_table(
            ["category", "AP"] * (n_cols // 2), rows))

        return {
            "AP-per-category": {name: ap for name, ap in per_category},
            "AP-ratios": {
                "AP-" + name: cols for name, cols in per_category_ratios
            },
        }


class COCOEvaluatorWithAnchors(COCOEvaluator):
    """COCOEvaluator that also stores each image's proposals WITH their
    source anchors for anchor/proposal diagnosis — the counterpart of the
    reference's `COCOEvaluatorWithAnchors`
    (coco_evaluation_with_anchors.py:28-159): dumps `box_proposals.pkl`
    with keys boxes/anchors/objectness_logits/ids (:36-53) and attaches the
    per-detection "anchor" field to the instance json
    (instances_to_coco_json_with_anchor, :113-117, XYWH like bbox)."""

    def reset(self):
        super().reset()
        self._proposals = []

    def process(self, batch, outputs):
        super().process(batch, outputs)
        batch_valid = batch.get("batch_valid", [True] * len(batch["image_id"]))

        # per-detection anchors -> instance json "anchor" field (XYWH)
        if "anchors" in outputs:
            det_anchors = np.asarray(outputs["anchors"])
            det_valid = np.asarray(outputs["valid"])
            preds = self._predictions[-int(np.sum(batch_valid)):]
            pi = 0
            for i in range(len(batch["image_id"])):
                if not batch_valid[i]:
                    continue
                pred = preds[pi]
                pi += 1
                rows = [j for j in range(det_anchors.shape[1]) if det_valid[i, j]]
                # process() sorted instances by score; recover that order
                order = np.argsort(
                    [-float(np.asarray(outputs["scores"])[i, j]) for j in rows],
                    kind="stable",
                )
                for inst, oj in zip(pred["instances"], order):
                    x1, y1, x2, y2 = det_anchors[i, rows[oj]].tolist()
                    inst["anchor"] = [x1, y1, x2 - x1, y2 - y1]

        if "proposals" not in outputs:
            return
        props = np.asarray(outputs["proposals"])
        scores = np.asarray(outputs.get("proposal_scores"))
        valid = np.asarray(outputs.get("proposal_valid"))
        anchors = outputs.get("proposal_anchors")
        anchors = np.asarray(anchors) if anchors is not None else None
        for i, image_id in enumerate(batch["image_id"]):
            if not batch_valid[i]:
                continue
            m = valid[i] if valid is not None else np.ones(len(props[i]), bool)
            self._proposals.append({
                "image_id": int(image_id),
                "proposals": props[i][m],
                "anchors": anchors[i][m] if anchors is not None else None,
                "scores": scores[i][m] if scores is not None else None,
            })

    def evaluate(self):
        results = super().evaluate()
        if self._output_dir and self._proposals:
            import pickle

            # reference pkl schema (coco_evaluation_with_anchors.py:45-51)
            proposal_data = {
                "boxes": [p["proposals"] for p in self._proposals],
                "anchors": [p["anchors"] for p in self._proposals],
                "objectness_logits": [p["scores"] for p in self._proposals],
                "ids": [p["image_id"] for p in self._proposals],
                "bbox_mode": "XYXY_ABS",
            }
            with open(os.path.join(self._output_dir, "box_proposals.pkl"),
                      "wb") as f:
                pickle.dump(proposal_data, f)
        return results
