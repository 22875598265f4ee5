"""Box math on (..., 4) XYXY tensors (counterpart of
``slenderobjdet_tpu/structures/boxes.py``: the parts the predict path and the
evaluator use). ``area``, ``xywh_to_xyxy``, ``pairwise_intersection`` and
``pairwise_iou`` take torch tensors or, on the host side of the evaluator,
numpy arrays, and keep the JAX package's order of floating-point operations."""

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
