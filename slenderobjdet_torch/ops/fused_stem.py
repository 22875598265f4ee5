"""Fused ResNet stem: 7x7/2 conv + FrozenBN affine + relu + 3x3/2 max-pool
(counterpart of ``slenderobjdet_tpu/ops/fused_stem.py``).

- ``reference_stem``: the plain PyTorch version (``F.conv2d`` +
  ``F.max_pool2d``), the kernel's oracle.
- ``fused_stem``: a ``torch.autograd.Function`` around the CUDA kernel
  ``csrc/fused_stem.cu``; CPU tensors take ``reference_stem``. Its backward
  is autograd of ``reference_stem`` on the saved inputs, as the JAX
  package's ``custom_vjp`` differentiates the XLA composition.
- ``stem_eligible``: the static gate the backbone checks.

Layouts are the JAX package's: x NHWC (B, H, W, 3), w HWIO (7, 7, 3, Cs),
output (B, H/4, W/4, Cs) in x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_bottleneck import reference_grads


def stem_eligible(x_shape, w_shape) -> bool:
    """3 input channels, a 7x7 kernel, and H and W divisible by 4."""
    _, h, w, cin = x_shape
    return cin == 3 and tuple(w_shape[:3]) == (7, 7, 3) and h % 4 == 0 \
        and w % 4 == 0


def _fold(w: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    """FrozenBN scale folded into the weights and rounded to dtype."""
    return (w.float() * scale.float()).to(dtype)


def reference_stem(x, w, scale, bias):
    """relu(conv7x7/2(x, w * scale) + bias) -> maxpool 3x3/2, with fp32
    accumulation of dtype products, the bias added in fp32 and the relu output
    rounded to dtype before the pool."""
    wf = _fold(w, scale, x.dtype).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wf, stride=2, padding=3)
    y = torch.relu(y + bias.float().view(1, -1, 1, 1)).to(x.dtype)
    # max commutes with the rounding above, so pooling in fp32 is exact
    y = F.max_pool2d(y.float(), 3, stride=2, padding=1).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def _launch(x, w, scale, bias):
    _build.require_cuda("fused_stem", x, w, scale, bias)
    code = _build.dtype_code("fused_stem", x.dtype)
    b, h, wd, _ = x.shape
    if not stem_eligible(x.shape, w.shape):
        raise ValueError(f"fused_stem: ineligible shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    cs = w.shape[-1]
    lib = _build.library()
    if lib.fused_stem_smem_bytes(cs) > torch.cuda.get_device_properties(
            x.device).shared_memory_per_block_optin:
        raise ValueError(f"fused_stem: {cs} output channels do not fit in "
                         f"shared memory")
    x = x.contiguous()
    wf = _fold(w, scale, x.dtype).float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty((b, h // 4, wd // 4, cs), dtype=x.dtype, device=x.device)
    rc = lib.fused_stem_launch(code, x.data_ptr(), wf.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), b, h, wd, cs,
                               _build.stream_ptr(x))
    _build.check(rc, "fused_stem_launch")
    _build.LAUNCHES["fused_stem"] += 1
    return out


class _FusedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        if x.device.type == "cpu":
            return reference_stem(x, w, scale, bias)
        return _launch(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        return reference_grads(reference_stem, ctx.saved_tensors,
                               ctx.needs_input_grad, g)


def fused_stem(x, w, scale, bias):
    """Fused stem forward through the CUDA kernel for CUDA tensors (CPU
    tensors take ``reference_stem``); differentiable, with the gradients of
    ``reference_stem``."""
    return _FusedStem.apply(x, w, scale, bias)
