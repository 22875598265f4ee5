"""Deformable convolution, v1 and v2 (counterpart of
``slenderobjdet_tpu/ops/deform_conv.py``: ``kernel_base_offsets``,
``deform_conv2d_batched``, ``deform_sample_batched``, ``deform_apply`` and
the flat gather with its custom VJP).

The JAX package's formulation, channels last: the irregular 3x3 sampling is
a bilinear gather giving (B, H, W, K, Cin) samples, and the convolution is
one matmul (B*H*W, K*Cin) @ (K*Cin, Cout) with float32 accumulation, then
the bias, then a cast to the features' dtype. Callers in NCHW pass
``x.permute(0, 2, 3, 1)``, a view for ``channels_last`` tensors.

Offset convention: ``offsets[..., k, :] = (dy, dx)`` is the ABSOLUTE sampling
displacement of kernel point k from the output pixel, kernel base included
(torch DCN's relative offsets plus ``kernel_base_offsets``).

The gather (``_BilinearGather``, a ``torch.autograd.Function``): the batch is
one flat (B*H*W, C) table with image row offsets, and each sample reads its
four taps from it. A tap outside the map weighs zero (its row index is
clipped and the inside mask is folded into its lerp weight); the lerp
weights are in the features' dtype and the taps are summed in the order
00, 01, 10, 11. The backward saves only ``feat``, ``ys`` and ``xs`` and
recomputes the taps:
- the offset gradient is the exact finite bilinear derivative, summed over C
  in float32 (at an integer position, the forward difference; autograd is
  never asked to differentiate through ``floor``);
- the feature gradient is the gather's adjoint, ``index_add_`` of
  ``weight * grad`` into a float32 table cast back to the features' dtype, as
  ``ops/roi_align.py`` does. The JAX scatter adds in the features' dtype, so
  in bfloat16 the port's sum rounds once where JAX's rounds at every add; in
  float32 the two agree to the order of the adds.

Chunks bound the transient: the sample rows (B * H * W * K of them) are
gathered ``row_chunk`` at a time (default ``ROW_CHUNK`` = 2^17), so a tap
tensor holds at most 2^17 x C elements: 128 MB at C = 512 in bfloat16, and
the backward's float32 terms 256 MB each. A chunk size changes neither the
output nor the offset gradient; the feature gradient's float32 sums may add
in another order.

The JAX package's ``SLENDER_PAIR_GATHER``, ``SLENDER_PAIRSLICE_GATHER`` and
``SLENDER_DEFORM_AUTODIFF_VJP`` variants are TPU A/B records whose outputs
equal the flat gather's; they are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ROW_CHUNK = 1 << 17


def kernel_base_offsets(kernel_size: int = 3) -> np.ndarray:
    """(K, 2) (dy, dx) grid of a centred kernel, row-major."""
    pad = (kernel_size - 1) // 2
    base = np.arange(-pad, pad + 1, dtype=np.float32)
    dy = np.repeat(base, kernel_size)
    dx = np.tile(base, kernel_size)
    return np.stack([dy, dx], axis=1)


def _corner(ys, xs, dtype):
    """The top-left tap (y0, x0) (n,) int64 of float32 sample positions
    ``ys``, ``xs`` (n,) and the fractions ``ly``, ``lx`` (n, 1) in
    ``dtype``."""
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    ly = (ys - y0f).to(dtype)[:, None]
    lx = (xs - x0f).to(dtype)[:, None]
    y0, x0 = y0f.long(), x0f.long()
    return y0, x0, ly, lx


def _tap_rows(y0, x0, base, h: int, w: int, dtype):
    """Flat-table row indices (4, n) of the taps 00, 01, 10, 11 of samples
    whose image starts at row ``base`` (n,), clipped to the map, and their
    inside masks (4, n, 1) in ``dtype``."""
    idx, inside = [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        inside.append(((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(dtype)[:, None])
        idx.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + base)
    return torch.stack(idx), torch.stack(inside)


def _lerp_weights(ly, lx, one):
    """The bilinear weights of the taps 00, 01, 10, 11, in ly's dtype."""
    return ((one - ly) * (one - lx), (one - ly) * lx, ly * (one - lx), ly * lx)


class _BilinearGather(torch.autograd.Function):
    """feat (B, H, W, C); ys, xs (B, ...) float32 -> (B, ..., C) in feat's
    dtype, zero outside the map (module docstring)."""

    @staticmethod
    def forward(ctx, feat, ys, xs, row_chunk):
        b, h, w, c = feat.shape
        flat = feat.reshape(b * h * w, c)
        n_per_image = ys[0].numel()
        n = ys.numel()
        yf, xf = ys.reshape(-1), xs.reshape(-1)
        out = torch.empty((n, c), dtype=feat.dtype, device=feat.device)
        one = torch.ones((), dtype=feat.dtype, device=feat.device)
        for s in range(0, n, row_chunk):
            e = min(n, s + row_chunk)
            base = torch.arange(s, e, device=feat.device) // n_per_image * (h * w)
            y0, x0, ly, lx = _corner(yf[s:e], xf[s:e], feat.dtype)
            idx, inside = _tap_rows(y0, x0, base, h, w, feat.dtype)
            acc = out[s:e]
            for t, wgt in enumerate(_lerp_weights(ly, lx, one)):
                term = flat.index_select(0, idx[t]).mul_(wgt * inside[t])
                if t == 0:
                    acc.copy_(term)
                else:
                    acc.add_(term)
        ctx.save_for_backward(feat, ys, xs)
        ctx.row_chunk = row_chunk
        return out.view(*ys.shape, c)

    @staticmethod
    def backward(ctx, grad):
        feat, ys, xs = ctx.saved_tensors
        b, h, w, c = feat.shape
        dt = feat.dtype
        flat = feat.reshape(b * h * w, c)
        n_per_image = ys[0].numel()
        n = ys.numel()
        yf, xf = ys.reshape(-1), xs.reshape(-1)
        g = grad.reshape(n, c)
        want_feat = ctx.needs_input_grad[0]
        want_pos = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        one = torch.ones((), dtype=dt, device=feat.device)
        dflat = torch.zeros((b * h * w, c), dtype=torch.float32, device=feat.device)
        dys = torch.empty(n, dtype=torch.float32, device=feat.device)
        dxs = torch.empty(n, dtype=torch.float32, device=feat.device)
        for s in range(0, n, ctx.row_chunk):
            e = min(n, s + ctx.row_chunk)
            base = torch.arange(s, e, device=feat.device) // n_per_image * (h * w)
            y0, x0, ly, lx = _corner(yf[s:e], xf[s:e], dt)
            idx, inside = _tap_rows(y0, x0, base, h, w, dt)
            g32 = g[s:e].float()
            if want_pos:
                # the taps with the zero-outside mask, in the features' dtype
                u00, u01, u10, u11 = (flat.index_select(0, idx[t]) * inside[t]
                                      for t in range(4))
                dys[s:e] = (g32 * ((u10 - u00) * (one - lx)
                                   + (u11 - u01) * lx).float()).sum(-1)
                dxs[s:e] = (g32 * ((u01 - u00) * (one - ly)
                                   + (u11 - u10) * ly).float()).sum(-1)
                del u00, u01, u10, u11
            if want_feat:
                for t, wgt in enumerate(_lerp_weights(ly, lx, one)):
                    dflat.index_add_(0, idx[t], g32 * (wgt * inside[t]).float())
        return (dflat.view(b, h, w, c).to(dt) if want_feat else None,
                dys.view(ys.shape).to(ys.dtype) if want_pos else None,
                dxs.view(xs.shape).to(xs.dtype) if want_pos else None, None)


def _positions(x: torch.Tensor, offsets: torch.Tensor):
    """Absolute sample positions (B, H, W, K) of each output pixel's kernel
    points: its row and column plus the (dy, dx) offsets."""
    _, h, w, _ = x.shape
    ys = torch.arange(h, dtype=offsets.dtype, device=offsets.device)[None, :, None, None] \
        + offsets[..., 0]
    xs = torch.arange(w, dtype=offsets.dtype, device=offsets.device)[None, None, :, None] \
        + offsets[..., 1]
    return ys, xs


def deform_sample_batched(x: torch.Tensor, offsets: torch.Tensor,
                          row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Bilinear sampling only: x (B, H, W, Cin), offsets (B, H, W, K, 2)
    absolute (dy, dx) -> samples (B, H, W, K, Cin) in x's dtype. Lets several
    deformable convs AT THE SAME OFFSETS gather once from channel-concatenated
    features (RepPoints' cls and reg convs)."""
    ys, xs = _positions(x, offsets)
    return _BilinearGather.apply(x, ys, xs, row_chunk)


def deform_apply(samples: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, H, W, K, Cin) samples x (K, Cin, Cout) weight -> (B, H, W, Cout):
    the matmul half of the deformable conv, in the samples' dtype with float32
    accumulation; the bias, cast to that dtype, is added in the matmul's
    epilogue (``addmm``), then the result is cast to ``out_dtype``. In
    bfloat16 that rounds the bias and the sum where the JAX package adds a
    float32 bias to a float32 product and rounds once."""
    b, h, w, k, cin = samples.shape
    a = samples.reshape(b * h * w, k * cin)
    wm = weight.reshape(k * cin, -1).to(a.dtype)
    out = a @ wm if bias is None else torch.addmm(bias.to(a.dtype), a, wm)
    return out.view(b, h, w, -1).to(out_dtype or samples.dtype)


def deform_conv2d_batched(x: torch.Tensor, offsets: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Deformable conv over a batch: x (B, H, W, Cin), offsets
    (B, H, W, K, 2) absolute (dy, dx), weight (K, Cin, Cout), bias (Cout,),
    mask (B, H, W, K) the v2 modulation -> (B, H, W, Cout) in x's dtype."""
    samples = deform_sample_batched(x, offsets, row_chunk)
    if mask is not None:
        samples = samples * mask[..., None].to(samples.dtype)
    return deform_apply(samples, weight, bias, out_dtype=x.dtype)
