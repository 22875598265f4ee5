"""FPN neck and backbone builders (counterpart of
``slenderobjdet_tpu/models/backbones/fpn.py``). Tensors are NCHW."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, get_norm
from .resnet import RESNET_STRIDES, resnet_from_cfg, resnet_output_channels


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), exact nearest-neighbour 2x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    """Feature pyramid over a bottom-up backbone.

    top_block: "" | "maxpool" (P6 = P5 subsampled by 2) | "p6p7_p5" |
    "p6p7_res5" (P6/P7 by 3x3/2 convs from P5 or from res5).
    """

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str],
                 in_channels: Sequence[int], out_channels: int = 256,
                 norm: str = "", fuse_type: str = "sum",
                 top_block: str = "maxpool"):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.top_block = top_block
        use_bias = norm == ""
        for idx, cin in enumerate(in_channels):
            self.add_module(f"fpn_lateral{idx}",
                            Conv2d(cin, out_channels, 1, bias=use_bias))
            self.add_module(f"fpn_output{idx}",
                            Conv2d(out_channels, out_channels, 3, padding=1,
                                   bias=use_bias))
            if norm:
                self.add_module(f"fpn_lateral{idx}_norm",
                                get_norm(norm, out_channels))
                self.add_module(f"fpn_output{idx}_norm",
                                get_norm(norm, out_channels))
        self.norm = norm
        self.start_stage = RESNET_STRIDES[self.in_features[0]].bit_length() - 1
        if top_block in ("p6p7_p5", "p6p7_res5"):
            src = out_channels if top_block == "p6p7_p5" else in_channels[-1]
            self.top_p6 = Conv2d(src, out_channels, 3, 2, 1)
            self.top_p7 = Conv2d(out_channels, out_channels, 3, 2, 1)
        elif top_block not in ("", "maxpool"):
            raise ValueError(f"unknown FPN top block {top_block!r}")

    def _conv(self, name, x):
        x = getattr(self, name)(x)
        return getattr(self, f"{name}_norm")(x) if self.norm else x

    def forward(self, x) -> Dict[str, torch.Tensor]:
        bottom_up_features = self.bottom_up(x)
        laterals = [self._conv(f"fpn_lateral{idx}", bottom_up_features[f])
                    for idx, f in enumerate(self.in_features)]

        merged: List[torch.Tensor] = [None] * len(laterals)
        merged[-1] = laterals[-1]
        for idx in range(len(laterals) - 2, -1, -1):
            m = laterals[idx] + upsample2x_nearest(merged[idx + 1])
            merged[idx] = m / 2.0 if self.fuse_type == "avg" else m

        outputs: Dict[str, torch.Tensor] = {}
        for idx, m in enumerate(merged):
            outputs[f"p{self.start_stage + idx}"] = self._conv(
                f"fpn_output{idx}", m)

        n = self.start_stage + len(merged) - 1
        if self.top_block == "maxpool":
            outputs[f"p{n + 1}"] = outputs[f"p{n}"][:, :, ::2, ::2]
        elif self.top_block in ("p6p7_p5", "p6p7_res5"):
            src = (outputs[f"p{n}"] if self.top_block == "p6p7_p5"
                   else bottom_up_features[self.in_features[-1]])
            p6 = self.top_p6(src)
            outputs[f"p{n + 1}"] = p6
            outputs[f"p{n + 2}"] = self.top_p7(F.relu(p6))
        return outputs


def _build_resnet_fpn(cfg, top_block: str) -> FPN:
    bottom_up = resnet_from_cfg(cfg)
    in_features = tuple(cfg.MODEL.FPN.IN_FEATURES)
    chans = resnet_output_channels(cfg.MODEL.RESNETS.DEPTH,
                                   cfg.MODEL.RESNETS.RES2_OUT_CHANNELS)
    return FPN(
        bottom_up=bottom_up,
        in_features=in_features,
        in_channels=[chans[f] for f in in_features],
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        top_block=top_block,
    )


def build_resnet_fpn_backbone(cfg) -> FPN:
    return _build_resnet_fpn(cfg, top_block="maxpool")


def build_retinanet_resnet_fpn_backbone(cfg) -> FPN:
    return _build_resnet_fpn(cfg, top_block="p6p7_res5")


def build_retinanet_resnet_fpn_backbone_use_p5(cfg) -> FPN:
    return _build_resnet_fpn(cfg, top_block="p6p7_p5")


def build_resnet_backbone(cfg) -> nn.Module:
    return resnet_from_cfg(cfg)


BACKBONES = {
    "build_resnet_fpn_backbone": build_resnet_fpn_backbone,
    "build_retinanet_resnet_fpn_backbone": build_retinanet_resnet_fpn_backbone,
    "build_retinanet_resnet_fpn_backbone_use_p5":
        build_retinanet_resnet_fpn_backbone_use_p5,
    "build_resnet_backbone": build_resnet_backbone,
}


def build_backbone(cfg) -> nn.Module:
    name = cfg.MODEL.BACKBONE.NAME
    if name not in BACKBONES:
        raise KeyError(f"backbone {name!r} is not ported; available: "
                       f"{sorted(BACKBONES)}")
    return BACKBONES[name](cfg)
