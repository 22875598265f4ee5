"""ResNet backbone (counterpart of
``slenderobjdet_tpu/models/backbones/resnet.py``).

Tensors are NCHW in ``torch.channels_last`` memory, so ``x.permute(0, 2, 3,
1)`` is already a contiguous NHWC tensor for the fused kernels. Module and
parameter names follow the Flax tree (``stem_conv1``, ``res2_0.conv1``, ...),
which keeps ``checkpoint/bridge.py`` a renaming.

Two seams run hand-written CUDA kernels in place of the plain layers, as the
JAX package's Pallas seams do:
- ``MODEL.RESNETS.FUSED_STEM``: the stem (``ops/fused_stem.py``);
- ``MODEL.RESNETS.FUSED_BLOCKS``: each stride-1, groups-1, dilation-1
  FrozenBN bottleneck block (``ops/fused_bottleneck.py``) whose conv2 is not
  deformable.
Both fold the FrozenBN scale into a weight rounded to the compute dtype and
add the bias in fp32; in bf16 they differ from the plain path by rounding.
With any other norm (``MODEL.RESNETS.NORM`` GN, BN, SyncBN or "") neither
seam runs, as in the JAX package: a fixed affine cannot hold a batch
statistic.

``MODEL.RESNETS.DEFORM_ON_PER_STAGE`` makes a stage's conv2 a ``DFConv2d``
(modulated with ``DEFORM_MODULATED``) where it has stride 1, groups 1 and
dilation 1; such a block takes the plain path.

``TPU.REMAT_BACKBONE`` recomputes every residual block's activations in the
backward instead of storing them (``layers.rematerialized``; the stem is
stored), as the JAX package's ``nn.remat`` does; the modules, and so the
state dict, are the same with the flag on or off.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fused_bottleneck import fused_bottleneck
from ...ops.fused_stem import fused_stem, stem_eligible
from ..layers import Conv2d, DFConv2d, get_norm, rematerialized

# depth -> (block type, stage block counts)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

RESNET_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


def _apply(norm, x):
    return x if norm is None else norm(x)


def _hwio(conv: nn.Conv2d, norm, dtype):
    """The conv's weight as HWIO with the FrozenBN scale folded in, rounded
    to dtype, and the FrozenBN bias: ``(kernel * s).astype(dtype), b``."""
    return (conv.weight.permute(2, 3, 1, 0) * norm.scale).to(dtype), norm.bias


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.norm1 = get_norm(norm, features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.norm2 = get_norm(norm, features)
        if in_channels != features or stride != 1:
            self.shortcut = Conv2d(in_channels, features, 1, stride,
                                   bias=False)
            self.shortcut_norm = get_norm(norm, features)
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(_apply(self.norm1, self.conv1(x)))
        out = _apply(self.norm2, self.conv2(out))
        sc = x if self.shortcut is None else _apply(self.shortcut_norm,
                                                    self.shortcut(x))
        return F.relu(out + sc)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, bottleneck: int,
                 stride: int = 1, stride_in_1x1: bool = True, groups: int = 1,
                 dilation: int = 1, norm: str = "FrozenBN",
                 fused: bool = False, deform: bool = False,
                 deform_modulated: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.stride, self.groups, self.dilation = stride, groups, dilation
        self.norm = norm
        self.fused = fused
        self.deform = deform
        self.conv1 = Conv2d(in_channels, bottleneck, 1, s1, bias=False)
        self.norm1 = get_norm(norm, bottleneck)
        if deform and s3 == 1 and groups == 1 and dilation == 1:
            self.conv2 = DFConv2d(bottleneck, bottleneck, modulated=deform_modulated)
        else:
            self.conv2 = Conv2d(bottleneck, bottleneck, 3, s3, padding=dilation,
                                dilation=dilation, groups=groups, bias=False)
        self.norm2 = get_norm(norm, bottleneck)
        self.conv3 = Conv2d(bottleneck, features, 1, bias=False)
        self.norm3 = get_norm(norm, features)
        if in_channels != features or stride != 1:
            self.shortcut = Conv2d(in_channels, features, 1, stride,
                                   bias=False)
            self.shortcut_norm = get_norm(norm, features)
        else:
            self.shortcut = None

    def fused_eligible(self) -> bool:
        return (self.fused and self.stride == 1 and not self.deform
                and self.groups == 1 and self.dilation == 1
                and self.norm == "FrozenBN")

    def _fused_call(self, x):
        """The whole block as one fused kernel call, FrozenBN folded into
        each conv's (weight, bias)."""
        dt = x.dtype
        w1, b1 = _hwio(self.conv1, self.norm1, dt)
        w2, b2 = _hwio(self.conv2, self.norm2, dt)
        w3, b3 = _hwio(self.conv3, self.norm3, dt)
        wsc = bsc = None
        if self.shortcut is not None:
            wsc, bsc = _hwio(self.shortcut, self.shortcut_norm, dt)
            wsc = wsc[0, 0]
        out = fused_bottleneck(x.permute(0, 2, 3, 1), w1[0, 0], b1, w2, b2,
                               w3[0, 0], b3, wsc, bsc)
        return out.permute(0, 3, 1, 2)

    def forward(self, x):
        if self.fused_eligible():
            return self._fused_call(x)
        out = F.relu(_apply(self.norm1, self.conv1(x)))
        out = F.relu(_apply(self.norm2, self.conv2(out)))
        out = _apply(self.norm3, self.conv3(out))
        sc = x if self.shortcut is None else _apply(self.shortcut_norm,
                                                    self.shortcut(x))
        return F.relu(out + sc)


class ResNet(nn.Module):
    """ResNet trunk returning ``{name: feature}`` for ``out_features``."""

    def __init__(self, depth: int = 50, norm: str = "FrozenBN",
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 num_groups: int = 1, width_per_group: int = 64,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, res5_dilation: int = 1,
                 deform_on_per_stage: Sequence[bool] = (False,) * 4,
                 deform_modulated: bool = False,
                 fused_blocks: bool = False, fused_stem: bool = False,
                 remat: bool = False):
        super().__init__()
        block_type, stage_blocks = RESNET_SPECS[depth]
        self.norm = norm
        self.remat = remat
        self.out_features = tuple(out_features)
        self.strides = {f: RESNET_STRIDES[f] for f in self.out_features}
        self.fused_stem = fused_stem
        self.stem_conv1 = Conv2d(3, stem_out_channels, 7, 2, 3, bias=False)
        self.stem_norm = get_norm(norm, stem_out_channels)

        out_channels = res2_out_channels if block_type == "bottleneck" else 64
        bottleneck_channels = num_groups * width_per_group
        in_channels = stem_out_channels
        self.stages = []
        for stage_idx, num_blocks in enumerate(stage_blocks):
            name = f"res{stage_idx + 2}"
            first_stride = 1 if stage_idx == 0 else 2
            dilation = res5_dilation if name == "res5" else 1
            if dilation > 1:
                first_stride = 1
            blocks = []
            for block_idx in range(num_blocks):
                stride = first_stride if block_idx == 0 else 1
                if block_type == "bottleneck":
                    block = BottleneckBlock(
                        in_channels, out_channels, bottleneck_channels,
                        stride=stride, stride_in_1x1=stride_in_1x1,
                        groups=num_groups, dilation=dilation, norm=norm,
                        fused=fused_blocks,
                        deform=deform_on_per_stage[stage_idx],
                        deform_modulated=deform_modulated)
                else:
                    block = BasicBlock(in_channels, out_channels,
                                       stride=stride, norm=norm)
                self.add_module(f"{name}_{block_idx}", block)
                blocks.append(f"{name}_{block_idx}")
                in_channels = out_channels
            self.stages.append((name, blocks))
            out_channels *= 2
            bottleneck_channels *= 2

    def _stem(self, x):
        if self.fused_stem and self.norm == "FrozenBN":
            xh = x.permute(0, 2, 3, 1)                      # NHWC
            w = self.stem_conv1.weight.permute(2, 3, 1, 0)  # HWIO
            if stem_eligible(xh.shape, w.shape):
                out = fused_stem(xh, w, self.stem_norm.scale,
                                 self.stem_norm.bias)
                return out.permute(0, 3, 1, 2)
        out = F.relu(_apply(self.stem_norm, self.stem_conv1(x)))
        return F.max_pool2d(out, 3, stride=2, padding=1)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = self._stem(x)
        features: Dict[str, torch.Tensor] = {}
        for name, blocks in self.stages:
            for block in blocks:
                m = getattr(self, block)
                out = rematerialized(m, out) if self.remat else m(out)
            if name in self.out_features:
                features[name] = out
        return features


def resnet_output_channels(depth: int, res2_out_channels: int = 256) -> Dict[str, int]:
    base = res2_out_channels if depth >= 50 else 64
    return {f"res{i + 2}": base * (2 ** i) for i in range(4)}


def resnet_from_cfg(cfg) -> ResNet:
    """The trunk of ``MODEL.RESNETS``. NORM is any norm of ``get_norm``:
    "FrozenBN", "GN", "BN" / "SyncBN" (trainable, batch statistics in a
    loss) or "". The fused seams fold a fixed affine, so they run with
    FrozenBN only, as in the JAX package; another trunk takes the plain
    layers. FREEZE_AT is applied by the optimizer (``requires_grad_``), so
    a frozen stage's BatchNorm still normalises by batch statistics and
    updates its running ones in a loss, as the JAX package's does."""
    r = cfg.MODEL.RESNETS
    return ResNet(
        depth=r.DEPTH,
        norm=r.NORM,
        out_features=tuple(r.OUT_FEATURES),
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1,
        res5_dilation=r.RES5_DILATION,
        deform_on_per_stage=tuple(r.DEFORM_ON_PER_STAGE),
        deform_modulated=r.DEFORM_MODULATED,
        fused_blocks=r.FUSED_BLOCKS,
        fused_stem=r.FUSED_STEM,
        remat=cfg.TPU.REMAT_BACKBONE,
    )
