"""Shared building blocks (counterpart of ``slenderobjdet_tpu/models/layers.py``).

Tensors are NCHW (in ``torch.channels_last`` memory inside the backbone);
parameters are float32 and the compute dtype is the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in the input's
    dtype, as Flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
