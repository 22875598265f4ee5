"""Fused ResNet bottleneck block (counterpart of
``slenderobjdet_tpu/ops/fused_bottleneck.py``).

- ``reference_bottleneck``: the plain PyTorch version (``F.conv2d``), the
  kernel's oracle.
- ``fused_bottleneck``: the wrapper of the CUDA kernel
  ``csrc/fused_bottleneck.cu``; CPU tensors take ``reference_bottleneck``.

Layouts are the JAX package's: x NHWC (B, H, W, Cin); w1 (Cin, Cm),
w2 (3, 3, Cm, Cm) HWIO, w3 (Cm, Cout), wsc (Cin, Cout) or None for the
identity shortcut; biases (C,) float32. Weights are pre-folded (FrozenBN
absorbed) and used in x's dtype. Stride-1, groups-1, dilation-1 blocks only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def reference_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + shortcut): each conv
    accumulates products of dtype values in fp32, adds its fp32 bias and
    applies relu, then rounds to dtype; an identity shortcut adds x in fp32."""
    dt = x.dtype

    def conv(v, w, pad):          # v NCHW fp32 holding dtype values, w HWIO
        w = w.to(dt).float().permute(3, 2, 0, 1)
        return F.conv2d(v, w, padding=pad)

    def b(v):
        return v.float().view(1, -1, 1, 1)

    xf = x.float().permute(0, 3, 1, 2)
    a1 = torch.relu(conv(xf, w1[None, None], 0) + b(b1)).to(dt).float()
    a2 = torch.relu(conv(a1, w2, 1) + b(b2)).to(dt).float()
    t = conv(a2, w3[None, None], 0) + b(b3)
    sc = xf if wsc is None else conv(xf, wsc[None, None], 0) + b(bsc)
    return torch.relu(t + sc).to(dt).permute(0, 2, 3, 1)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None):
    """Fused bottleneck forward through the CUDA kernel for CUDA tensors; CPU
    tensors take ``reference_bottleneck``."""
    if x.device.type == "cpu":
        return reference_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc, bsc)
    proj = wsc is not None
    tensors = [x, w1, b1, w2, b2, w3, b3] + ([wsc, bsc] if proj else [])
    _build.require_cuda("fused_bottleneck", *tensors)
    code = _build.dtype_code("fused_bottleneck", x.dtype)
    bsz, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    if (w1.shape != (cin, cm) or w2.shape != (3, 3, cm, cm)
            or w3.shape != (cm, cout)
            or (proj and wsc.shape != (cin, cout))
            or (not proj and cin != cout)):
        raise ValueError("fused_bottleneck: inconsistent shapes")
    dt = x.dtype
    x = x.contiguous()
    w1, w2, w3 = (t.to(dt).contiguous() for t in (w1, w2, w3))
    b1, b2, b3 = (t.float().contiguous() for t in (b1, b2, b3))
    if proj:
        wsc, bsc = wsc.to(dt).contiguous(), bsc.float().contiguous()
    out = torch.empty((bsz, h, w, cout), dtype=dt, device=x.device)
    rc = _build.library().fused_bottleneck_launch(
        code, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        wsc.data_ptr() if proj else None, bsc.data_ptr() if proj else None,
        out.data_ptr(), bsz, h, w, cin, cm, cout, _build.stream_ptr(x))
    _build.check(rc, "fused_bottleneck_launch")
    _build.LAUNCHES["fused_bottleneck"] += 1
    return out
