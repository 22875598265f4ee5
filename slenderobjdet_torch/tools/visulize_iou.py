"""The IoU-against-L1 figure of a box morphing into another (counterpart of
``tools/visulize_iou.py``, whose name keeps the reference's spelling; the
same flags and cases). Box 1 moves toward box 2 over ``steps``; the figure
plots the IoU (``l2``: areas, the real IoU; ``l1``: perimeters, the
reference's ablation) and the L1 distance against the step. The JAX tool
plots with matplotlib, which the card's machine lacks: this one draws the
two curves, their axes and the box outlines with ``utils/draw.py`` and
writes ``iou_<distance>_<i>.png``; ``curves`` returns the plotted values.

    python -m slenderobjdet_torch.tools.visulize_iou [--out-dir vis_iou] [--serve]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..utils import draw
from ._common import write_png

FIG_HW = (480, 640)
MARGIN = 40
IOU_COLOR, LOSS_COLOR, AXIS_COLOR, BOX_COLOR = (0, 0, 255), (255, 0, 0), (0, 0, 0), (90, 90, 90)


def l2(p1, p2):
    return p1 * p2


def l1(p1, p2):
    return p1 + p2


def iou(box_1, box_2, distance=l2):
    """IoU with the sides combined by ``distance``: l2 the areas (the real
    IoU), l1 the perimeters."""
    area_1 = distance(box_1[2] - box_1[0], box_1[3] - box_1[1])
    area_2 = distance(box_2[2] - box_2[0], box_2[3] - box_2[1])
    wh = -np.maximum(box_1[:2], box_2[:2]) + np.minimum(box_1[2:], box_2[2:])
    wh = (wh > 0) * wh
    intersection = distance(wh[0], wh[1])
    return intersection / (area_1 + area_2 - intersection)


def curves(box_1, box_2, steps=100, distance=l2):
    """The JAX tool's ``vis_boxes`` values: xs, IoUs, L1 losses, and the box
    pairs it outlines (every ``steps // 3``-th step)."""
    box_1 = box_1.copy()
    diff = (box_2 - box_1) / steps
    xs, ious, losses, outlined = [], [], [], []
    for i in range(steps):
        xs.append(i / steps)
        ious.append(iou(box_1, box_2, distance))
        losses.append(np.abs(box_1 - box_2).sum())
        if i % (steps // 3) == 0:
            outlined.append((i / steps, box_1.copy(), box_2.copy()))
        box_1 += diff
    return np.array(xs), np.array(ious), np.array(losses), outlined


def figure(xs, ious, losses, outlined) -> np.ndarray:
    """White canvas: x in [-0.5, 1.5] as the JAX figure's limits, IoU on the
    left scale [0, 1], L1 on its own scale, outlines at each step drawn."""
    h, w = FIG_HW
    img = np.full((h, w, 3), 255, np.uint8)
    x0, x1, y0, y1 = MARGIN, w - MARGIN, h - MARGIN, MARGIN

    def px(x):
        return x0 + (x + 0.5) / 2.0 * (x1 - x0)

    def py(v, top):
        return y0 - v / max(top, 1e-12) * (y0 - y1)

    draw.rectangle(img, (x0, y1), (x1, y0), AXIS_COLOR)
    top_loss = float(np.max(losses)) if len(losses) else 1.0
    max_val = max(max(b.max(), c.max()) for _, b, c in outlined) * 4 if outlined else 1.0
    for x, b, c in outlined:
        for box in (b, c):
            bw, bh = (box[2] - box[0]) / max_val, (box[3] - box[1]) / max_val
            draw.rectangle(img, (int(px(x)), int(py(0, 1))),
                           (int(px(x + bw / 2)), int(py(bh, 1))), BOX_COLOR)
    for vals, top, color in ((ious, 1.0, IOU_COLOR), (losses, top_loss, LOSS_COLOR)):
        pts = np.array([[px(x), py(v, top)] for x, v in zip(xs, vals)]).astype(np.int32)
        draw.polylines(img, [pts], False, color)
    draw.put_text(img, "IoU", (x0 + 4, y1 + 14), 0.35, IOU_COLOR)
    draw.put_text(img, "L1 loss", (x1 - 48, y1 + 14), 0.35, LOSS_COLOR)
    return img


CASES = [
    (np.array([0, 0, 20, 20], float), np.array([0, 0, 10, 80], float), l2),
    (np.array([0, 0, 10, 80], float), np.array([0, 0, 10, 10], float), l1),
]


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="vis_iou")
    ap.add_argument("--serve", action="store_true", help="also serve figures via webcv2")
    args = ap.parse_args(argv)
    written = []
    for i, (b1, b2, dist) in enumerate(CASES):
        img = figure(*curves(b1, b2, distance=dist))
        path = write_png(os.path.join(args.out_dir, f"iou_{dist.__name__}_{i}.png"), img)
        if args.serve:
            from ..utils import webcv2

            webcv2.imshow(f"iou_{i}", img)
        written.append(path)
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
