"""Box math on (..., 4) XYXY tensors (counterpart of
``slenderobjdet_tpu/structures/boxes.py``: the parts the predict path uses)."""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
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
