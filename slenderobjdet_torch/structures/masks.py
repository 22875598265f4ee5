"""Host-side slenderness (aspect-ratio) geometry.

Semantics mirror the reference's definition of an instance's "ratio"
(`concern/support.py:41-73`, `slender_det/evaluation/coco.py:60-85`):
the ratio of an instance is min(w,h)/max(w,h) of the *oriented* min-area
rectangle of the convex hull of its segmentation polygons; instances without
usable polygons fall back to the axis-aligned bbox ratio. This runs on the
host (numpy, and cv2 where it imports): data and evaluation preprocessing,
never on the card. A copy of ``slenderobjdet_tpu/structures/masks.py``, held
equal to it by ``tests/test_torch_eval.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def ratio_of_bbox_xyxy(bbox: Sequence[float]) -> float:
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    if w * h == 0:
        return 0.0
    return min(w, h) / max(w, h)


def ratio_of_polygon(polygons: List[np.ndarray]) -> float:
    """polygons: list of flat [x0,y0,x1,y1,...] arrays for one instance."""
    pts = np.concatenate([np.asarray(p, dtype=np.float32) for p in polygons])
    pts = pts.reshape(-1, 2)
    if not _HAS_CV2:
        return ratio_of_bbox_xyxy(
            [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
        )
    hull = cv2.convexHull(pts.astype(np.float32)).reshape(-1, 2)
    if hull.shape[0] < 3:
        return ratio_of_bbox_xyxy(
            [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
        )
    (_, _), (w, h), _ = cv2.minAreaRect(hull.astype(np.float32))
    if w * h == 0:
        return 0.0
    return min(w, h) / max(w, h)


def rbox_from_polygon(polygons: List[np.ndarray]) -> List[float]:
    """Oriented box [cx, cy, w, h, angle_deg] (XYWHA) from polygons, with the
    same angle normalization as the reference (`concern/support.py:76-93`):
    angle mapped into (-45, 45] with w/h swapped accordingly."""
    pts = np.concatenate([np.asarray(p, dtype=np.float32) for p in polygons])
    pts = pts.reshape(-1, 2)
    hull = cv2.convexHull(pts.astype(np.float32)).reshape(-1, 2)
    (cx, cy), (w, h), angle = cv2.minAreaRect(hull.astype(np.float32))
    angle = -angle
    while angle < 0:
        angle += 180
    while angle > 180:
        angle -= 180
    if angle > 90:
        w, h = h, w
        angle -= 90
    if angle > 45:
        angle -= 90
        w, h = h, w
    return [float(cx), float(cy), float(w), float(h), float(angle)]


def compute_ann_ratio(ann: dict, oriented: bool = True) -> float:
    """Compute the slenderness ratio of one COCO annotation dict, matching the
    forked COCO API (`evaluation/coco.py:60-85`)."""
    if "ratio" in ann:
        return ann["ratio"]
    segm = []
    if "segmentation" in ann and isinstance(ann["segmentation"], list):
        segm = [p for p in ann["segmentation"] if len(p) % 2 == 0 and len(p) >= 6]
    if ann.get("iscrowd", 0) or not segm:
        w, h = ann["bbox"][2], ann["bbox"][3]
        if not oriented:
            return w / max(h, 1e-12)
        if w * h == 0:
            return 0.0
        return min(w, h) / max(w, h)
    return ratio_of_polygon(segm)
