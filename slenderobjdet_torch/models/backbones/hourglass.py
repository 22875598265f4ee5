"""Stacked-Hourglass backbone for CornerNet (counterpart of
``slenderobjdet_tpu/models/backbones/hourglass.py``).

A stem at stride 4 (7x7/2 ``ConvBNRelu`` and a stride-2 ``Residual``), then
STACKS recursive hourglass modules of depth DEPTH_BLOCK with per-depth
channels CHANNELS_BLOCK and residual counts NUM_CONV_BLOCK; each stack's
``out_conv`` gives ``hourglass{s + 2}`` at stride 4, and the next stack
starts from ``inter_res(relu(inter_a(input) + inter_b(output)))``.
Configured by ``MODEL.HOURGLASS.*``; NORM is any norm of ``get_norm`` (the
yaml's is "BN": trainable, with batch statistics in a loss).

Tensors are NCHW in ``torch.channels_last`` memory. Module names are the
Flax tree's (``ConvBNRelu_0``, ``Residual_{i}`` numbered in creation order,
``hg{s}/HourglassBlock_0/...``, ``out_conv{s}``, ``inter_a{s}``,
``inter_b{s}``, ``inter_res{s}``); a ``ConvBNRelu``'s ``conv`` and ``norm``
are Flax's ``Conv_0`` and ``<Norm>_0`` (``checkpoint/bridge.py``).

``TPU.REMAT_BACKBONE`` recomputes every ``Residual`` (the stem's
``Residual_0`` and each ``inter_res{s}`` included) in the backward
(``layers.rematerialized``), as the JAX package's ``nn.remat`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, get_norm, rematerialized


class ConvBNRelu(nn.Module):
    """Conv (no bias, padding (k - 1) // 2), norm, and a ReLU unless
    ``relu`` is False."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 norm: str = "BN", relu: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride, (kernel - 1) // 2,
                           bias=False)
        self.norm = get_norm(norm, features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.relu else x


class Residual(nn.Module):
    """relu(ConvBNRelu_1(ConvBNRelu_0(x)) + shortcut), the shortcut a 1x1
    ``ConvBNRelu_2`` where the width or the stride changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, norm: str = "BN"):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_channels, features, 3, stride, norm)
        self.ConvBNRelu_1 = ConvBNRelu(features, features, 3, 1, norm, relu=False)
        self.ConvBNRelu_2 = (ConvBNRelu(in_channels, features, 1, stride, norm, relu=False)
                             if in_channels != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBNRelu_1(self.ConvBNRelu_0(x))
        sc = x if self.ConvBNRelu_2 is None else self.ConvBNRelu_2(x)
        return F.relu(out + sc)


def _residual(module: Residual, x: torch.Tensor, remat: bool) -> torch.Tensor:
    return rematerialized(module, x) if remat else module(x)


class HourglassBlock(nn.Module):
    """A recursive hourglass of ``depth``: up1 = residuals at channels[0];
    low = 2x2 max pool, residuals to channels[1], the inner hourglass (or,
    at depth 1, num_convs[1] more residuals), residuals back to
    channels[0]; out = up1 + nearest 2x upsample of low."""

    def __init__(self, depth: int, channels: Sequence[int], num_convs: Sequence[int],
                 norm: str = "BN", remat: bool = False):
        super().__init__()
        c_cur, c_next = channels[0], channels[1]
        n_cur, n_next = num_convs[0], num_convs[1]
        self.remat = remat
        count = 0

        def residuals(specs):
            nonlocal count
            names = []
            for cin, cout in specs:
                self.add_module(f"Residual_{count}", Residual(cin, cout, norm=norm))
                names.append(f"Residual_{count}")
                count += 1
            return names

        self.up1 = residuals([(c_cur, c_cur)] * n_cur)
        self.low1 = residuals([(c_cur if i == 0 else c_next, c_next) for i in range(n_cur)])
        if depth > 1:
            self.HourglassBlock_0 = HourglassBlock(depth - 1, channels[1:], num_convs[1:],
                                                   norm, remat)
            self.low2 = []
        else:
            self.HourglassBlock_0 = None
            self.low2 = residuals([(c_next, c_next)] * n_next)
        self.low3 = residuals([(c_next, c_cur if i == n_cur - 1 else c_next)
                               for i in range(n_cur)])

    def _run(self, names, x):
        for name in names:
            x = _residual(getattr(self, name), x, self.remat)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self._run(self.up1, x)
        low = self._run(self.low1, F.max_pool2d(x, 2, 2))
        low = self.HourglassBlock_0(low) if self.HourglassBlock_0 is not None \
            else self._run(self.low2, low)
        low = self._run(self.low3, low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


class Hourglass(nn.Module):
    """The stacked trunk: ``{"hourglass{s + 2}": (B, CHANNELS_BLOCK[0], H / 4,
    W / 4)}`` for every stack. H and W must be multiples of
    ``size_divisibility`` (2 ** depth_block * 4)."""

    def __init__(self, stacks: int = 2, depth_block: int = 5,
                 channels_block: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 num_conv_block: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 stem_out_channels: int = 128, norm: str = "BN", remat: bool = False):
        super().__init__()
        c0 = channels_block[0]
        self.stacks = stacks
        self.remat = remat
        self.size_divisibility = 2 ** depth_block * 4
        self.ConvBNRelu_0 = ConvBNRelu(3, stem_out_channels, 7, 2, norm)
        self.Residual_0 = Residual(stem_out_channels, c0, stride=2, norm=norm)
        for s in range(stacks):
            self.add_module(f"hg{s}", HourglassBlock(depth_block, channels_block,
                                                     num_conv_block, norm, remat))
            self.add_module(f"out_conv{s}", ConvBNRelu(c0, c0, 3, 1, norm))
            if s < stacks - 1:
                self.add_module(f"inter_a{s}", ConvBNRelu(c0, c0, 1, 1, norm, relu=False))
                self.add_module(f"inter_b{s}", ConvBNRelu(c0, c0, 1, 1, norm, relu=False))
                self.add_module(f"inter_res{s}", Residual(c0, c0, norm=norm))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h, w = x.shape[2:]
        d = self.size_divisibility
        if h % d or w % d:
            raise ValueError(f"Hourglass: input {h} x {w} is not a multiple of its "
                             f"size_divisibility {d} (2 ** DEPTH_BLOCK * 4); pad the "
                             f"images to it")
        x = _residual(self.Residual_0, self.ConvBNRelu_0(x), self.remat)
        outputs: Dict[str, torch.Tensor] = {}
        inter = x
        for s in range(self.stacks):
            feat = getattr(self, f"out_conv{s}")(getattr(self, f"hg{s}")(inter))
            outputs[f"hourglass{s + 2}"] = feat
            if s < self.stacks - 1:
                a = getattr(self, f"inter_a{s}")(inter)
                b = getattr(self, f"inter_b{s}")(feat)
                inter = _residual(getattr(self, f"inter_res{s}"), F.relu(a + b), self.remat)
        return outputs


def build_hourglass_backbone(cfg) -> Hourglass:
    h = cfg.MODEL.HOURGLASS
    return Hourglass(
        stacks=h.STACKS,
        depth_block=h.DEPTH_BLOCK,
        channels_block=tuple(h.CHANNELS_BLOCK),
        num_conv_block=tuple(h.NUM_CONV_BLOCK),
        stem_out_channels=h.STEM_OUT_CHANNELS,
        norm=h.NORM,
        remat=cfg.TPU.REMAT_BACKBONE,
    )
