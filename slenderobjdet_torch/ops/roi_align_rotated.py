"""ROIAlignRotated over the RoIAlign engine of ``ops/roi_align.py``
(counterpart of ``slenderobjdet_tpu/ops/roi_align_rotated.py``:
``roi_align_rotated``, ``multilevel_roi_align_rotated`` and
``multilevel_roi_align_rotated_fused``; detectron2's ROIAlignRotated, which
the reference's rotated two-stage configs select with POOLER_TYPE
"ROIAlignRotated").

RoIs are (cx, cy, w, h, angle_deg), the angle counter-clockwise in image
coordinates; the op is always "aligned" (the centre moves by -0.5 in the
level's coordinates). Each bin averages ``S x S`` bilinear samples on a
local grid turned by theta about the centre:

    y = yy * cos(theta) - xx * sin(theta) + cy
    x = yy * sin(theta) + xx * cos(theta) + cx

with ``yy = (-0.5 + (p + (s + 0.5) / S) / P) * h`` (and ``xx`` alike in w);
a tap outside the map clamps to the border. The grid is not separable in y
and x, so each of the ``P * P * S * S`` samples gets its own four taps;
those taps and weights go through the axis-aligned pooler's gather engine
(``roi_align._GatherPool``: one ``index_select`` and a batched matmul a
chunk, and the exact adjoint as the backward), so autograd gives the
features' gradient. RoIs get none.

Levels go by ``sqrt(w * h)`` (``assign_fpn_levels`` of the proxy box (0, 0,
w, h)). The JAX package pools every RoI from every level in training and
keeps the assigned one; here both multilevel entry points pool from the
assigned level only, the same samples: one engine, as ``roi_align.py``'s
train and predict poolers are.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .roi_align import ROI_CHUNK, _GatherPool, assign_fpn_levels, level_table


def _rotated_taps(rois, base, heights, widths, scale, P: int, S: int):
    """Row indices into the flat level table and weights of every tap of
    every bin: (N, P, P, S * S * 4) each, the weights holding the 1 / S^2 of
    the bin's mean. ``base``, ``heights``, ``widths`` (N,) int64 and
    ``scale`` (N,) float32 give each RoI's level."""
    dev = rois.device
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    roi_w = rois[:, 2] * scale
    roi_h = rois[:, 3] * scale
    theta = rois[:, 4] * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)

    ps = (torch.arange(P, device=dev)[:, None]
          + (torch.arange(S, device=dev)[None, :] + 0.5) / S)          # (P, S)
    yy = (-0.5 + ps[None] / P) * roi_h[:, None, None]                   # (N, P, S)
    xx = (-0.5 + ps[None] / P) * roi_w[:, None, None]
    yy = yy[:, :, :, None, None]                                        # (N, P, S, 1, 1)
    xx = xx[:, None, None, :, :]                                        # (N, 1, 1, P, S)

    def col(t):
        return t[:, None, None, None, None]

    y = yy * col(cos_t) - xx * col(sin_t) + col(cy)                     # (N, P, S, P, S)
    x = yy * col(sin_t) + xx * col(cos_t) + col(cx)

    def axis(c, size):
        c0 = torch.floor(c)
        frac = c - c0
        last = col(size - 1)
        i0 = torch.minimum(c0.long().clamp(min=0), last)
        i1 = torch.minimum(i0 + 1, last)
        return torch.stack([i0, i1], -1), torch.stack([1.0 - frac, frac], -1)

    yi, wy = axis(y, heights)                                           # (..., 2)
    xi, wx = axis(x, widths)
    n = rois.shape[0]
    # (n, p, s1, q, s2, ty, tx) -> (n, p, q, s1, s2, ty, tx)
    idx = (yi[..., :, None] * col(widths)[..., None, None] + col(base)[..., None, None]
           + xi[..., None, :]).permute(0, 1, 3, 2, 4, 5, 6)
    weight = (wy[..., :, None] * wx[..., None, :]).permute(0, 1, 3, 2, 4, 5, 6)
    return idx.reshape(n, P, P, -1), (weight / (S * S)).reshape(n, P, P, -1)


def _pool_rotated(flat, rois, base, heights, widths, scale, P, S, chunk):
    with torch.no_grad():
        idx, weight = _rotated_taps(rois.float(), base, heights, widths, scale, P, S)
    return _GatherPool.apply(flat, idx, weight, chunk)


def roi_align_rotated(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                      output_size: int = 7, sampling_ratio: int = 2,
                      roi_chunk: int = ROI_CHUNK) -> torch.Tensor:
    """One level of one image: feat (H, W, C), rois (N, 5) XYWHA in image
    coordinates -> (N, P, P, C) float32."""
    h, w, c = feat.shape
    n = rois.shape[0]
    dev = feat.device

    def full(v, dtype=torch.int64):
        return torch.full((n,), v, dtype=dtype, device=dev)

    return _pool_rotated(feat.reshape(h * w, c), rois, full(0), full(h), full(w),
                         full(spatial_scale, torch.float32), output_size,
                         sampling_ratio, roi_chunk)


def multilevel_roi_align_rotated_fused(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_level: int = 4,
    roi_chunk: int = ROI_CHUNK,
) -> torch.Tensor:
    """Multilevel ROIAlignRotated over a batch: feats, one (B, C, H_l, W_l)
    tensor a level; rois (B, R, 5) XYWHA in image coordinates -> (B, R, P, P,
    C) float32, channels last, each RoI pooled from the level its
    ``sqrt(w * h)`` gives it. Differentiable in the features."""
    bsz, R = rois.shape[:2]
    dev = rois.device
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    shapes = [tuple(f.shape[2:]) for f in feats]
    areas = [h * w for h, w in shapes]
    total = sum(areas)
    heights = torch.tensor([h for h, _ in shapes], device=dev)
    widths = torch.tensor([w for _, w in shapes], device=dev)
    row_off = torch.tensor([sum(areas[:i]) for i in range(len(areas))], device=dev)
    inv_scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)

    flat_rois = rois.reshape(-1, 5).float()
    with torch.no_grad():
        zeros = torch.zeros_like(flat_rois[:, 0])
        proxy = torch.stack([zeros, zeros, flat_rois[:, 2], flat_rois[:, 3]], dim=-1)
        lvl = (assign_fpn_levels(proxy, min_level, max_level,
                                 canonical_level=canonical_level) - min_level
               ).clamp(0, len(feats) - 1)
        image = torch.arange(bsz, device=dev).repeat_interleave(R)
        base = image * total + row_off[lvl]
    out = _pool_rotated(level_table(feats), flat_rois, base, heights[lvl], widths[lvl],
                        inv_scale[lvl], output_size, sampling_ratio, roi_chunk)
    return out.view(bsz, R, *out.shape[1:])


# The JAX package's training pooler pools every level and selects; the
# selected samples are these (module docstring).
multilevel_roi_align_rotated = multilevel_roi_align_rotated_fused
