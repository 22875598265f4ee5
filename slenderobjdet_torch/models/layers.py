"""Shared building blocks (counterpart of ``slenderobjdet_tpu/models/layers.py``).

Tensors are NCHW (in ``torch.channels_last`` memory inside the backbone);
parameters are float32 and the compute dtype is the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import deform_apply, deform_conv2d_batched, kernel_base_offsets


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in the input's
    dtype, as Flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in the input's
    dtype, as Flax's ``nn.Dense(dtype=..., param_dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Scale(nn.Module):
    """Learnable scalar multiplier (per-FPN-level bbox scaling in FCOS)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init_value, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """Fixed per-channel affine y = x * scale + bias, computed in x's dtype.

    ``scale`` and ``bias`` are buffers (never trained), as the JAX package
    keeps them in its ``buffers`` collection."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm that reduces in float32 and casts back to the input dtype.

    eps is 1e-6, Flax's ``nn.GroupNorm`` default (torch's is 1e-5)."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__(num_groups, features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class DeformConvLayer(nn.Module):
    """3x3 deformable conv with the absolute-offset convention of
    ``ops/deform_conv.py`` (counterpart of the JAX package's
    ``meta_arch/reppoints.py:DeformConvLayer``): a float32 (K, Cin, Cout)
    ``weight`` drawn from normal(0, 0.01) and a zero ``bias``.

    Channels last: ``x`` (B, H, W, Cin) with offsets (B, H, W, K, 2), or
    ``samples`` (B, H, W, K, Cin) gathered once for several convs at the same
    offsets; the output (B, H, W, Cout) is in the input's dtype."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(9, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x=None, offsets=None, samples=None, mask=None):
        if samples is not None:
            return deform_apply(samples, self.weight, self.bias)
        return deform_conv2d_batched(x, offsets.float(), self.weight, self.bias, mask)


class DFConv2d(DeformConvLayer):
    """Offset-predicting 3x3 deformable conv, stride 1 (counterpart of the
    JAX package's ``layers.py:DFConv2d``): a zero-initialised 3x3
    ``offset_conv`` predicts 18 offsets (v1) or 27, offsets and a sigmoid
    mask (v2, ``modulated``), in torch DCN's relative (dy, dx) x 9 convention,
    shifted by ``kernel_base_offsets(3)`` to absolute ones. NCHW in and out
    (``channels_last`` memory)."""

    def __init__(self, in_channels: int, features: int, modulated: bool = True):
        super().__init__(in_channels, features)
        self.modulated = modulated
        self.offset_conv = Conv2d(in_channels, 27 if modulated else 18, 3, padding=1)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        pred = self.offset_conv(x).float().permute(0, 2, 3, 1)     # (B, H, W, 27)
        rel = pred[..., :18].reshape(b, h, w, 9, 2)
        mask = torch.sigmoid(pred[..., 18:]) if self.modulated else None
        base = torch.as_tensor(kernel_base_offsets(3), device=x.device)
        out = super().forward(x.permute(0, 2, 3, 1), rel + base, mask=mask)
        return out.permute(0, 3, 1, 2)


def get_norm(norm: str, features: int) -> Optional[nn.Module]:
    """Norm factory for the norms the predict path uses."""
    if norm == "" or norm is None:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(features)
    if norm == "GN":
        return GroupNorm32(features)
    if norm in ("BN", "SyncBN"):
        raise NotImplementedError(
            f"norm {norm!r} (trainable BatchNorm) is not ported yet")
    raise ValueError(f"Unknown norm {norm!r}")


@torch.no_grad()
def init_detector_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of a detector from ``generator`` (a CPU generator)
    as the JAX package initialises them: backbone and FPN convs lecun-normal
    (untruncated here), convs under ``head.`` normal(0, 0.01), conv biases 0,
    norms and scales at identity. Modules are visited in ``named_modules``
    order, which fixes the order of the draws; the caller sets the
    classification bias to its focal prior afterwards. A deformable conv's
    (K, Cin, Cout) weight is drawn from normal(0, 0.01) wherever it sits, and
    a ``DFConv2d``'s ``offset_conv`` starts at zero, so that its samples
    start on the plain conv's grid."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, m in model.named_modules():
        if isinstance(m, DeformConvLayer):
            normal(m.weight, 0.01)
            m.bias.zero_()
        elif name.endswith("offset_conv") and isinstance(m, nn.Conv2d):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            if name.startswith("head."):
                std = 0.01
            else:
                std = 1.0 / math.sqrt(m.weight[0].numel())
            normal(m.weight, std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)


def prior_bias(prior_prob: float) -> float:
    """The classification bias at which sigmoid gives ``prior_prob``."""
    return -math.log((1 - prior_prob) / prior_prob)
