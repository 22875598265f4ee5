"""Box math on (..., 4) XYXY tensors (counterpart of
``slenderobjdet_tpu/structures/boxes.py``): areas and IoU, the
Box2BoxTransform delta coding of the anchor-based detectors, and the ltrb
coding of FCOS. Every function but ``clip`` and ``decode_ltrb`` takes torch
tensors or, on the host side of the evaluator, numpy arrays, and all keep the
JAX package's order of floating-point operations."""

from __future__ import annotations

import numpy as np
import torch


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def area(boxes):
    """(..., 4) XYXY -> (...,) area."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clamp x to [0, w] and y to [0, h]; h and w are numbers or tensors that
    broadcast against ``boxes[..., 0]``."""
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.clamp(boxes[..., 0], zero, w)
    y1 = torch.clamp(boxes[..., 1], zero, h)
    x2 = torch.clamp(boxes[..., 2], zero, w)
    y2 = torch.clamp(boxes[..., 3], zero, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def decode_ltrb(locations: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """locations (..., 2) xy, ltrb (..., 4) distances -> XYXY boxes."""
    x1 = locations[..., 0] - ltrb[..., 0]
    y1 = locations[..., 1] - ltrb[..., 1]
    x2 = locations[..., 0] + ltrb[..., 2]
    y2 = locations[..., 1] + ltrb[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes, threshold: float = 0.0):
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold
    )


def xyxy_to_xywh(boxes):
    xp = _xp(boxes)
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return xp.stack([x1, y1, x2 - x1, y2 - y1], -1)


def xywh_to_xyxy(boxes):
    xp = _xp(boxes)
    x, y, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return xp.stack([x, y, x + w, y + h], -1)


def pairwise_intersection(boxes1, boxes2):
    """(N, 4), (M, 4) -> (N, M) intersection areas, as four separate (N, M)
    coordinate planes (the JAX package's operation order)."""
    xp = _xp(boxes1)
    ix1 = xp.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    iy1 = xp.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    ix2 = xp.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    iy2 = xp.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    w = xp.clip(ix2 - ix1, 0, None)
    h = xp.clip(iy2 - iy1, 0, None)
    return w * h


def pairwise_iou(boxes1, boxes2):
    """(N, 4), (M, 4) XYXY -> (N, M) IoU; 0 where the union is empty."""
    xp = _xp(boxes1)
    inter = pairwise_intersection(boxes1, boxes2)
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    floor = 1e-12 if xp is np else torch.full_like(union, 1e-12)
    zero = 0.0 if xp is np else torch.zeros_like(union)
    return xp.where(union > 0, inter / xp.maximum(union, floor), zero)


def pairwise_ioa(boxes1, boxes2):
    """Intersection over the area of boxes2: (N, 4), (M, 4) -> (N, M)."""
    xp = _xp(boxes1)
    inter = pairwise_intersection(boxes1, boxes2)
    a2 = area(boxes2)[None, :]
    return xp.where(a2 > 0, inter / xp.clip(a2, 1e-12, None), 0.0 * inter)


def elementwise_iou(boxes1, boxes2, eps: float = 1e-7):
    """(..., 4), (..., 4) -> (...,) IoU of corresponding boxes."""
    xp = _xp(boxes1)
    lt = xp.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = xp.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1) + area(boxes2) - inter
    return inter / xp.clip(union, eps, None)


# ------------------------------------------------------------------ deltas
# Box2BoxTransform (R-CNN, RPN, RetinaNet): per-coordinate weights, dw and dh
# clamped at log(1000 / 16) when decoding.

SCALE_CLAMP = float(np.log(1000.0 / 16.0))


def get_deltas(src_boxes, target_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """(..., 4) source and target boxes -> (..., 4) (dx, dy, dw, dh)."""
    xp = _xp(src_boxes)
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    eps = 1e-7
    dx = wx * (tgt_cx - src_cx) / xp.clip(src_w, eps, None)
    dy = wy * (tgt_cy - src_cy) / xp.clip(src_h, eps, None)
    dw = ww * xp.log(xp.clip(tgt_w, eps, None) / xp.clip(src_w, eps, None))
    dh = wh * xp.log(xp.clip(tgt_h, eps, None) / xp.clip(src_h, eps, None))
    return xp.stack([dx, dy, dw, dh], -1)


def apply_deltas(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """deltas (..., K*4) applied to boxes (..., 4) -> (..., K*4)."""
    xp = _xp(deltas)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    shape = tuple(deltas.shape)
    d = deltas.reshape(shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = xp.clip(d[..., 2] / ww, None, SCALE_CLAMP)
    dh = xp.clip(d[..., 3] / wh, None, SCALE_CLAMP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = xp.exp(dw) * w[..., None]
    pred_h = xp.exp(dh) * h[..., None]

    out = xp.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        -1,
    )
    return out.reshape(shape)


# ------------------------------------------------------------ FCOS ltrb
def ltrb_from_locations(locations, boxes):
    """locations (L, 2) xy, boxes (G, 4) -> (L, G, 4) left/top/right/bottom."""
    xp = _xp(locations)
    xs = locations[:, 0][:, None]
    ys = locations[:, 1][:, None]
    l = xs - boxes[None, :, 0]
    t = ys - boxes[None, :, 1]
    r = boxes[None, :, 2] - xs
    b = boxes[None, :, 3] - ys
    return xp.stack([l, t, r, b], -1)
