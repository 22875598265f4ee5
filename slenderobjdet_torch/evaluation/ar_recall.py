"""AR-by-(class x ratio-bucket x area-bucket) recall matrix.

Numpy implementation of the reference's diagnosis recall computation
(`slender_det/evaluation/coco_evaluation.py:283-417`): per image, greedily
match detections to gts globally by best IoU (class-agnostic in the K=-1
slot, class-matched otherwise), record per-gt best coverage, then compute
recall at IoU thresholds 0.5:0.05:0.95 for every (class, ratio, area) cell.
A copy of ``slenderobjdet_tpu/evaluation/ar_recall.py``; the box math is the
numpy side of ``structures/boxes.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..structures import boxes as box_ops

ASPECT_RATIOS = {
    "all ratios": [0.0, 1e5],
    " 0  - 1/5": [0.0, 1 / 5],
    "1/5 - 1/3": [1 / 5, 1 / 3],
    "1/3 - 3/1": [1 / 3, 3.0],
    "3/1 - 5/1": [3.0, 5.0],
    "5/1 - INF": [5.0, 1e5],
}
AREAS = {
    "all areas": [0, float("inf")],
    "small": [0, 32 ** 2],
    "medium": [32 ** 2, 96 ** 2],
    "large": [96 ** 2, float("inf")],
}


def between_ranges(value: float, ranges: List[List[float]]) -> np.ndarray:
    return np.array([r[0] <= value < r[1] for r in ranges], bool)


def evaluate_predictions_ar(
    predictions: List[Dict],
    coco_api,
    cat_id_to_contiguous: Dict[int, int],
    thresholds=None,
    aspect_ratios=None,
    areas=None,
    limit: int | None = 100,
) -> Dict:
    """predictions: list of {"image_id", "instances": [coco-format dt dicts]}
    with instances sorted by descending score."""
    aspect_ratios = aspect_ratios or ASPECT_RATIOS
    areas = areas or AREAS
    ratios = list(aspect_ratios.values())
    area_rngs = list(areas.values())
    K = len(coco_api.cats) + 1  # last slot: class-agnostic "all"
    R = len(ratios)
    A = len(area_rngs)

    counts_list, overlaps_list = [], []

    for pred in predictions:
        image_id = pred["image_id"]
        instances = pred["instances"]
        dt_boxes = np.array(
            [inst["bbox"] for inst in instances], np.float64
        ).reshape(-1, 4)
        dt_boxes = box_ops.xywh_to_xyxy(dt_boxes)
        dt_classes = np.array(
            [cat_id_to_contiguous.get(inst["category_id"], inst["category_id"])
             for inst in instances],
            np.int64,
        )

        anno = [
            a for a in coco_api.loadAnns(coco_api.getAnnIds(imgIds=image_id))
            if not a.get("iscrowd", 0)
        ]
        if len(anno) == 0 or len(instances) == 0:
            continue
        gt_boxes = box_ops.xywh_to_xyxy(
            np.array([a["bbox"] for a in anno], np.float64).reshape(-1, 4)
        )
        gt_classes = np.array(
            [cat_id_to_contiguous[a["category_id"]] for a in anno], np.int64
        )
        gt_ratios = np.array([a["ratio"] for a in anno], np.float64)
        gt_areas = box_ops.area(gt_boxes)

        count_matrix = np.zeros((K, R, A), np.int32)
        N = len(gt_boxes)
        overlap_matrix = np.zeros((K, R, A, N), np.float32)

        for i in range(N):
            k = gt_classes[i]
            r = between_ranges(gt_ratios[i], ratios)
            a = between_ranges(gt_areas[i], area_rngs)
            count_matrix[k][np.ix_(r, a)] += 1
            count_matrix[-1][np.ix_(r, a)] += 1

        if limit is not None and len(dt_boxes) > limit:
            dt_boxes = dt_boxes[:limit]
            dt_classes = dt_classes[:limit]

        overlaps = np.asarray(box_ops.pairwise_iou(dt_boxes, gt_boxes))
        matched = dt_classes[:, None] == gt_classes[None, :]
        overlaps_m = overlaps * matched

        for j in range(min(len(dt_boxes), N)):
            max_ov = overlaps.max(axis=0)
            arg_ov = overlaps.argmax(axis=0)
            max_ov_m = overlaps_m.max(axis=0)
            arg_ov_m = overlaps_m.argmax(axis=0)

            gt_ind = max_ov.argmax()
            gt_ind_m = max_ov_m.argmax()
            box_ind = arg_ov[gt_ind]
            box_ind_m = arg_ov_m[gt_ind_m]

            k = gt_classes[gt_ind_m]
            r = between_ranges(gt_ratios[gt_ind_m], ratios)
            a = between_ranges(gt_areas[gt_ind_m], area_rngs)
            overlap_matrix[k][np.ix_(r, a, [j])] = overlaps_m[box_ind_m, gt_ind_m]

            r_all = between_ranges(gt_ratios[gt_ind], ratios)
            a_all = between_ranges(gt_areas[gt_ind], area_rngs)
            overlap_matrix[-1][np.ix_(r_all, a_all, [j])] = overlaps[box_ind, gt_ind]

            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
            overlaps_m[box_ind_m, :] = -1
            overlaps_m[:, gt_ind_m] = -1

        counts_list.append(count_matrix)
        overlaps_list.append(overlap_matrix)

    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05, dtype=np.float32)
    T = len(thresholds)
    recalls = np.zeros((T, K, R, A), np.float64)
    for i, t in enumerate(thresholds):
        count = np.zeros((K, R, A), np.float64)
        hit = np.zeros((K, R, A), np.float64)
        for cm, om in zip(counts_list, overlaps_list):
            hit += (om >= t).sum(axis=-1)
            count += cm
        recalls[i] = hit / np.maximum(count, 1.0)

    ar = recalls[:, -1, 0, 0].mean()
    mar = recalls[:, :-1, 0, 0].mean()
    num_pos = (
        np.stack(counts_list).sum(0) if counts_list else np.zeros((K, R, A))
    )
    return {
        "ar": ar,
        "mar": mar,
        "recalls": recalls,
        "thresholds": thresholds,
        "num_pos": num_pos,
    }
