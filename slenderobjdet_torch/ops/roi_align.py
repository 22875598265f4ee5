"""RoIAlign with the aligned half-pixel grid, multilevel over an FPN
(counterpart of ``slenderobjdet_tpu/ops/roi_align.py``: ``roi_align``,
``assign_fpn_levels``, ``multilevel_roi_align``,
``multilevel_roi_align_fused`` and ``multilevel_roi_align_train``).

The JAX package's semantics, not detectron2's CUDA op's: sample
coordinates are ``(coord * scale - 0.5) + (p + (s + 0.5) / S) * bin``, each
output bin averages ``S x S`` bilinear samples (``S`` the static
``sampling_ratio``), and a tap outside the feature map clamps to the border.

One engine serves every entry point. The pyramid levels of all images are
flattened row-major into one (rows, C) table; each RoI's four taps a sample
index only its assigned level's rows (image and level row offset + y * W +
x). A chunk of RoIs gathers its taps with one ``index_select`` and reduces
them with one batched matmul against the per-bin tap weights, in float32.
The backward (a ``torch.autograd.Function``) is the exact adjoint of that
gather: the same weights times the output gradient, ``index_add_``-ed into
a float32 table and cast to the features' dtype, as the JAX custom VJP
accumulates in float32 (it forms the adjoint as two dense matmuls a level,
the MXU's form; an indexed add is the GPU's). RoIs get no gradient.

At a level one pixel wide the JAX fused poolers' pair slice reads the next
row's first pixel as the right tap; here the right tap clamps to the border,
as the JAX all-level pooler and ``roi_align`` do. Nothing in the model's
configurations has such a level.

Chunks bound the transient: a chunk of ``roi_chunk`` RoIs gathers
``roi_chunk * P * P * 4 * S * S`` rows of C channels (512 RoIs at P 7, S 2,
C 256: 411 MB in float32).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

ROI_CHUNK = 512


def assign_fpn_levels(rois: torch.Tensor, min_level: int, max_level: int,
                      canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """detectron2's assign_boxes_to_levels on (N, 4) XYXY rois:
    floor(k0 + log2(sqrt(area) / 224 + 1e-8)), clipped; int64."""
    areas = torch.clamp((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]),
                        min=1e-6)
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(areas) / canonical_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).long()


def _taps(rois, base, heights, widths, scale, P: int, S: int):
    """Row indices into the flat table and weights of every tap of every
    bin: (N, P, P, S * S * 4) each, the weights holding the 1 / S^2 of the
    bin's mean. ``base``, ``heights``, ``widths`` (N,) int64 and ``scale``
    (N,) float32 give each RoI's level."""
    dev = rois.device
    r = rois * scale[:, None]
    x1 = r[:, 0] - 0.5
    y1 = r[:, 1] - 0.5
    roi_w = r[:, 2] - 0.5 - x1
    roi_h = r[:, 3] - 0.5 - y1
    ps = (torch.arange(P, device=dev)[:, None]
          + (torch.arange(S, device=dev)[None, :] + 0.5) / S)        # (P, S)
    ys = y1[:, None, None] + ps[None] * (roi_h / P)[:, None, None]   # (N, P, S)
    xs = x1[:, None, None] + ps[None] * (roi_w / P)[:, None, None]

    def axis(c, size):
        c0 = torch.floor(c)
        frac = c - c0
        last = (size - 1)[:, None, None]
        i0 = torch.minimum(c0.long().clamp(min=0), last)
        i1 = torch.minimum(i0 + 1, last)
        return torch.stack([i0, i1], -1), torch.stack([1.0 - frac, frac], -1)

    yi, wy = axis(ys, heights)                                      # (N, P, S, 2)
    xi, wx = axis(xs, widths)
    rows = yi * widths[:, None, None, None] + base[:, None, None, None]
    n = rois.shape[0]
    # (n, p, q, s1, s2, ty, tx)
    idx = rows[:, :, None, :, None, :, None] + xi[:, None, :, None, :, None, :]
    weight = wy[:, :, None, :, None, :, None] * wx[:, None, :, None, :, None, :]
    return idx.reshape(n, P, P, -1), (weight / (S * S)).reshape(n, P, P, -1)


class _GatherPool(torch.autograd.Function):
    """out[n, p, q] = sum_k weight[n, p, q, k] * flat[idx[n, p, q, k]] in
    float32, chunk by chunk over n; the backward adds weight * grad into a
    float32 table at the same rows."""

    @staticmethod
    def forward(ctx, flat, idx, weight, chunk):
        n, P, _, K = idx.shape
        C = flat.shape[1]
        out = torch.empty((n, P, P, C), dtype=torch.float32, device=flat.device)
        for s in range(0, n, chunk):
            i, w = idx[s:s + chunk], weight[s:s + chunk]
            m = i.shape[0] * P * P
            taps = flat.index_select(0, i.reshape(-1)).view(m, K, C).float()
            out[s:s + chunk] = torch.bmm(w.reshape(m, 1, K), taps).view(-1, P, P, C)
        ctx.save_for_backward(idx, weight)
        ctx.flat_meta = (flat.shape, flat.dtype, chunk)
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, weight = ctx.saved_tensors
        shape, dtype, chunk = ctx.flat_meta
        C = shape[1]
        out = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        for s in range(0, idx.shape[0], chunk):
            g = grad[s:s + chunk].float()
            contrib = weight[s:s + chunk, ..., None] * g[:, :, :, None, :]
            out.index_add_(0, idx[s:s + chunk].reshape(-1), contrib.reshape(-1, C))
        return out.to(dtype), None, None, None


def _pool(flat, rois, base, heights, widths, scale, P, S, chunk):
    with torch.no_grad():
        idx, weight = _taps(rois.float(), base, heights, widths, scale, P, S)
    return _GatherPool.apply(flat, idx, weight, chunk)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2,
              roi_chunk: int = ROI_CHUNK) -> torch.Tensor:
    """One level of one image: feat (H, W, C), rois (N, 4) XYXY in image
    coordinates -> (N, P, P, C) float32."""
    h, w, c = feat.shape
    n = rois.shape[0]
    dev = feat.device

    def full(v, dtype=torch.int64):
        return torch.full((n,), v, dtype=dtype, device=dev)

    return _pool(feat.reshape(h * w, c), rois, full(0), full(h), full(w),
                 full(spatial_scale, torch.float32), output_size,
                 sampling_ratio, roi_chunk)


def level_table(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, C, H_l, W_l) levels -> the (B * sum H_l W_l, C) table: image by
    image, level by level, row-major (y, x). A view where a level is in
    channels_last memory, then one copy."""
    bsz, c = feats[0].shape[:2]
    return torch.cat([f.permute(0, 2, 3, 1).reshape(bsz, -1, c) for f in feats],
                     dim=1).reshape(-1, c)


def multilevel_roi_align_fused(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_level: int = 4,
    roi_chunk: int = ROI_CHUNK,
) -> torch.Tensor:
    """Single-gather multilevel RoIAlign over a batch: feats, one (B, C, H_l,
    W_l) tensor a level (strides ``strides``); rois (B, R, 4) XYXY in image
    coordinates -> (B, R, P, P, C) float32, channels last, each RoI pooled
    from the level ``assign_fpn_levels`` gives it. Differentiable in the
    features."""
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
    inv_scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                             device=dev)

    flat_rois = rois.reshape(-1, 4).float()
    with torch.no_grad():
        # a NaN RoI (a diverged model's) gets some level and pools NaN
        lvl = (assign_fpn_levels(flat_rois, min_level, max_level,
                                 canonical_level=canonical_level) - min_level
               ).clamp(0, len(feats) - 1)
        image = torch.arange(bsz, device=dev).repeat_interleave(R)
        base = image * total + row_off[lvl]
    out = _pool(level_table(feats), flat_rois, base, heights[lvl], widths[lvl],
                inv_scale[lvl], output_size, sampling_ratio, roi_chunk)
    return out.view(bsz, R, *out.shape[1:])


def multilevel_roi_align(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_level: int = 4,
    roi_chunk: int = ROI_CHUNK,
) -> torch.Tensor:
    """The pool-every-level-and-select pooler: as
    ``multilevel_roi_align_fused``, but each image's RoIs are pooled from
    every level by ``roi_align`` and each keeps the level
    ``assign_fpn_levels`` gives it, so it gathers as many taps as there are
    levels for each RoI. The same result up to the order of the bin's sum."""
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    out = []
    for b in range(rois.shape[0]):
        r = rois[b].float()
        levels = assign_fpn_levels(r, min_level, max_level, canonical_level=canonical_level)
        pooled = 0.0
        for i, (feat, stride) in enumerate(zip(feats, strides)):
            p = roi_align(feat[b].permute(1, 2, 0), r, 1.0 / stride, output_size,
                          sampling_ratio, roi_chunk)
            pooled = pooled + torch.where((levels == min_level + i)[:, None, None, None], p, 0.0)
        out.append(pooled)
    return torch.stack(out)


# The JAX package keeps a forward-only predict pooler and a custom-VJP train
# pooler; here one ``autograd.Function`` is both (module docstring).
multilevel_roi_align_train = multilevel_roi_align_fused
