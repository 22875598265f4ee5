"""Detection visualizer with slenderness-ratio grouping, without cv2.

Counterpart of ``slenderobjdet_tpu/utils/visualizer.py``: the same API and
the same pixels, drawn by ``utils/draw.py`` (cv2 5.0's rectangles, 8-connected
lines, polylines, filled polygons, weighted blend, ``INTER_LINEAR`` resize
and ``FONT_HERSHEY_SIMPLEX`` labels, transcribed in numpy) so that it runs on
a machine without cv2. ``tests/test_torch_visualizer.py`` holds every method
pixel-equal to the JAX visualizer run with cv2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import draw

RATIO_RANGES = [(0.0, 1 / 5), (1 / 5, 1 / 3), (1 / 3, 3.0), (3.0, 5.0),
                (5.0, 1e5)]
RATIO_COLORS = [(0, 0, 255), (0, 128, 255), (0, 255, 0), (255, 128, 0),
                (255, 0, 0)]  # BGR: red = most slender
LABEL_SCALE = 0.35


def ratio_group(w: float, h: float) -> int:
    r = w / max(h, 1e-6)
    for i, (lo, hi) in enumerate(RATIO_RANGES):
        if lo <= r < hi:
            return i
    return len(RATIO_RANGES) - 1


def _label(i, scores, classes, class_names) -> str:
    label = ""
    if classes is not None:
        c = int(np.asarray(classes)[i])
        label = class_names[c] if class_names and c < len(class_names) else str(c)
    if scores is not None:
        label += f" {float(np.asarray(scores)[i]):.2f}"
    return label


def put_label(img: np.ndarray, text: str, x1: int, y1: int, color, lift: int = 2) -> None:
    """A label above a box's top-left corner, as the JAX tools place it."""
    draw.put_text(img, text, (x1, max(y1 - lift, 8)), LABEL_SCALE, color)


class Visualizer:
    def __init__(self, image_bgr: np.ndarray,
                 class_names: Optional[Sequence[str]] = None):
        self.img = image_bgr.copy()
        self.class_names = class_names

    def draw_boxes(self, boxes: np.ndarray, scores=None, classes=None,
                   color_by_ratio: bool = True, thickness: int = 1
                   ) -> np.ndarray:
        """boxes: (N, 4) XYXY."""
        for i, box in enumerate(np.asarray(boxes)):
            x1, y1, x2, y2 = [int(v) for v in box]
            color = (RATIO_COLORS[ratio_group(x2 - x1, y2 - y1)]
                     if color_by_ratio else (0, 255, 0))
            draw.rectangle(self.img, (x1, y1), (x2, y2), color, thickness)
            label = _label(i, scores, classes, self.class_names)
            if label:
                put_label(self.img, label, x1, y1, color)
        return self.img

    def draw_rotated_boxes(self, rboxes: np.ndarray, thickness: int = 1
                           ) -> np.ndarray:
        for box in np.asarray(rboxes):
            cx, cy, w, h, a = [float(v) for v in box]
            pts = draw.box_points((cx, cy), (w, h), -a).astype(np.int32)
            draw.polylines(self.img, [pts], True, RATIO_COLORS[ratio_group(w, h)], thickness)
        return self.img

    def draw_proposals(self, proposals: np.ndarray, max_n: int = 50
                       ) -> np.ndarray:
        for box in np.asarray(proposals)[:max_n]:
            x1, y1, x2, y2 = [int(v) for v in box]
            draw.rectangle(self.img, (x1, y1), (x2, y2), (180, 180, 180))
        return self.img

    def draw_anchors(self, anchors: np.ndarray, max_n: int = 50
                     ) -> np.ndarray:
        """Anchors as corner ticks in yellow, apart from the proposals."""
        for box in np.asarray(anchors)[:max_n]:
            x1, y1, x2, y2 = [int(v) for v in box]
            t = max(2, min(x2 - x1, y2 - y1) // 4)
            color = (0, 220, 220)
            for (cx, cy, dx, dy) in ((x1, y1, 1, 1), (x2, y1, -1, 1),
                                     (x1, y2, 1, -1), (x2, y2, -1, -1)):
                draw.line(self.img, (cx, cy), (cx + dx * t, cy), color)
                draw.line(self.img, (cx, cy), (cx, cy + dy * t), color)
        return self.img

    def draw_instances(self, boxes: Optional[np.ndarray] = None,
                       masks: Optional[List] = None, scores=None,
                       classes=None, alpha: float = 0.45,
                       color_by_ratio: bool = True) -> np.ndarray:
        """Filled polygon masks blended at ``alpha``, box outlines and
        labels, coloured by each instance's slenderness group. masks: per
        instance a list of (K, 2) xy arrays or COCO flat polygons."""
        n = len(boxes) if boxes is not None else len(masks)
        boxes = np.asarray(boxes) if boxes is not None else None
        overlay = self.img.copy()
        colors = []
        for i in range(n):
            if boxes is not None:
                x1, y1, x2, y2 = boxes[i]
                w, h = x2 - x1, y2 - y1
            elif masks is not None and len(masks[i]):
                allp = np.concatenate(_as_polygons(masks[i]), axis=0)
                w = allp[:, 0].max() - allp[:, 0].min()
                h = allp[:, 1].max() - allp[:, 1].min()
            else:
                w = h = 1.0
            color = (RATIO_COLORS[ratio_group(float(w), float(h))]
                     if color_by_ratio else (0, 255, 0))
            colors.append(color)
            if masks is not None and i < len(masks) and len(masks[i]):
                polys = [p.astype(np.int32) for p in _as_polygons(masks[i])]
                draw.fill_poly(overlay, polys, color)
                draw.polylines(self.img, polys, True, color)
        self.img = draw.add_weighted(overlay, alpha, self.img, 1.0 - alpha, 0)
        for i in range(n):
            if boxes is not None:
                x1, y1, x2, y2 = [int(v) for v in boxes[i]]
                draw.rectangle(self.img, (x1, y1), (x2, y2), colors[i])
                label = _label(i, scores, classes, self.class_names)
                if label:
                    put_label(self.img, label, x1, y1, colors[i])
        return self.img

    def get(self) -> np.ndarray:
        return self.img


def _as_polygons(polys) -> List[np.ndarray]:
    """COCO flat [x0, y0, x1, y1, ...] lists or (K, 2) arrays -> (K, 2)
    float64 arrays."""
    out = []
    for p in polys:
        a = np.asarray(p, np.float64)
        out.append(a.reshape(-1, 2) if a.ndim == 1 else a)
    return out


def group_by(object_list: Sequence, values: Sequence[float],
             ranges_dic: Dict[str, Sequence[Tuple[float, float]]]
             ) -> Dict[str, List]:
    """Objects grouped by whether their value falls in any of a key's
    ranges; ranges may overlap, so an object may land in several groups."""
    grouped: Dict[str, List] = {k: [] for k in ranges_dic}
    for obj, v in zip(object_list, values):
        for key, ranges in ranges_dic.items():
            rs = ranges if isinstance(ranges[0], (list, tuple)) else [ranges]
            if any(lo <= v < hi for lo, hi in rs):
                grouped[key].append(obj)
    return grouped


def smart_concatenate(images: List[np.ndarray], num_rows: Optional[int] = None,
                      num_columns: Optional[int] = None,
                      out_shape: Optional[Tuple[int, int]] = None
                      ) -> np.ndarray:
    """Same-shaped images tiled into a grid canvas, each resized to its
    cell by ``draw.resize_linear``."""
    n = len(images)
    assert n > 0 and all(im.shape == images[0].shape for im in images)
    if num_rows is None and num_columns is None:
        num_columns = int(math.sqrt(n)) or 1
        num_rows = int(math.ceil(n / num_columns))
    elif num_rows is None:
        num_rows = int(math.ceil(n / num_columns))
    elif num_columns is None:
        num_columns = int(math.ceil(n / num_rows))

    canvas = np.zeros_like(images[0])
    if out_shape is not None:
        canvas = draw.resize_linear(canvas, out_shape[::-1])
    h = canvas.shape[0] // num_rows
    w = canvas.shape[1] // num_columns
    for r in range(num_rows):
        for c in range(num_columns):
            idx = r * num_columns + c
            if idx >= n:
                break
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = draw.resize_linear(
                images[idx], (w, h))
    return canvas
