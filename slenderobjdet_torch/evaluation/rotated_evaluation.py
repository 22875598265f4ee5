"""Rotated-box COCO evaluation, evaluator_type "rcoco" (counterpart of
``slenderobjdet_tpu/evaluation/rotated_evaluation.py``; detectron2's
RotatedCOCOEvaluator as the reference's rotated configs use it): the COCO
protocol with the box IoU replaced by the exact rotated IoU.

The host IoU needs no cv2, which the card's machine does not have: the
JAX package's ``cv2.rotatedRectangleIntersection``, ``cv2.convexHull`` and
``cv2.contourArea`` are ``structures/rotated_rect.py:rectangle_intersection``
and ``structures/borders.py``'s ``convex_hull`` and ``contour_area``,
transcriptions that give cv2's results bit for bit, so the IoU is the JAX
package's on every machine (``tests/test_torch_rotated_geometry.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import MetadataCatalog
from ..parallel.multihost import all_gather_objects, is_main_process, process_count
from ..structures.borders import contour_area, convex_hull
from ..structures.rotated_rect import rectangle_intersection
from .coco_api import COCO
from .slender_cocoeval import SlenderCOCOeval


def rotated_iou_np(dt: np.ndarray, gt: np.ndarray, iscrowd) -> np.ndarray:
    """dt (D, 5), gt (G, 5) XYWHA -> (D, G) float64 rotated IoU; a crowd gt's
    denominator is the detection's area. cv2's rectangles turn clockwise,
    ours counter-clockwise (detectron2's), so the angle is negated."""
    D, G = len(dt), len(gt)
    out = np.zeros((D, G), np.float64)

    def rect(b):
        return ((float(b[0]), float(b[1])), (float(b[2]), float(b[3])), float(-b[4]))

    for i in range(D):
        r1 = rect(dt[i])
        a1 = dt[i][2] * dt[i][3]
        for j in range(G):
            a2 = gt[j][2] * gt[j][3]
            ret, pts = rectangle_intersection(r1, rect(gt[j]))
            inter = 0.0
            if ret != 0 and len(pts) >= 3:
                hull = convex_hull(pts)
                inter = contour_area(hull) if hull is not None else 0.0
            denom = a1 if iscrowd[j] else (a1 + a2 - inter)
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


class RotatedSlenderCOCOeval(SlenderCOCOeval):
    """SlenderCOCOeval whose IoU is rotated: annotations carry a 5-element
    XYWHA ``bbox``. The detections' ratio buckets read bbox[2] / bbox[3],
    w / h for XYWHA boxes too."""

    def computeIoU(self, imgId, catId):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: self.params.maxDets[-1]]
        g = np.array([x["bbox"] for x in gt], np.float64).reshape(-1, 5)
        d = np.array([x["bbox"] for x in dt], np.float64).reshape(-1, 5)
        iscrowd = [int(x.get("iscrowd", 0)) for x in gt]
        return rotated_iou_np(d, g, iscrowd)


class RotatedCOCOEvaluator:
    """Gathers XYWHA predictions and evaluates rotated AP."""

    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        self._metadata = MetadataCatalog.get(dataset_name)
        self._output_dir = output_dir
        self._coco_api = COCO(self._metadata.get("json_file"))
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        if id_map is None:
            cat_ids = sorted(self._coco_api.getCatIds())
            id_map = {v: i for i, v in enumerate(cat_ids)}
        self._contig_to_ds = {v: k for k, v in id_map.items()}
        # ground truth takes its rbox, or its axis-aligned box at angle 0
        for ann in self._coco_api.anns.values():
            if "rbox" in ann:
                ann["bbox"] = list(ann["rbox"])
            elif len(ann["bbox"]) == 4:
                x, y, w, h = ann["bbox"]
                ann["bbox"] = [x + w / 2, y + h / 2, w, h, 0.0]
        self.reset()

    def reset(self):
        self._predictions: List[Dict] = []

    def process(self, batch, outputs):
        boxes = np.asarray(outputs["boxes"])      # (B, D, 5) XYWHA
        if boxes.ndim != 3 or boxes.shape[-1] != 5:
            raise ValueError(f"the rcoco evaluator takes rotated (B, D, 5) boxes, got "
                             f"{boxes.shape}: a rotated detector's predictions")
        scores = np.asarray(outputs["scores"])
        classes = np.asarray(outputs["classes"])
        valid = np.asarray(outputs["valid"])
        batch_valid = batch.get("batch_valid", [True] * len(batch["image_id"]))
        for i, image_id in enumerate(batch["image_id"]):
            if not batch_valid[i]:
                continue
            insts = [{"image_id": int(image_id),
                      "category_id": self._contig_to_ds[int(classes[i, j])],
                      "bbox": [float(v) for v in boxes[i, j]],
                      "score": float(scores[i, j])}
                     for j in range(boxes.shape[1]) if valid[i, j]]
            insts.sort(key=lambda d: -d["score"])
            self._predictions.append({"image_id": int(image_id), "instances": insts})

    def evaluate(self):
        if process_count() > 1:
            gathered = all_gather_objects(self._predictions)
            if not is_main_process():
                self._predictions = []
                return OrderedDict()
            self._predictions = [p for ps in gathered for p in ps]
        results: OrderedDict = OrderedDict()
        coco_results = [i for p in self._predictions for i in p["instances"]]
        if not coco_results:
            results["bbox"] = {"AP": float("nan"), "AP50": float("nan")}
            return results
        # loadRes takes the area from bbox[2] * bbox[3], w * h here too
        coco_dt = self._coco_api.loadRes(coco_results)
        e = RotatedSlenderCOCOeval(self._coco_api, coco_dt, "bbox")
        e.params.imgIds = sorted({p["image_id"] for p in self._predictions})
        e.evaluate()
        e.accumulate()
        stats = e.summarize()
        from .coco_evaluation import STATS_NAMES

        results["bbox"] = {n: float(stats[i] * 100) for i, n in enumerate(STATS_NAMES)}
        return results
