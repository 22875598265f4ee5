"""The visual-transformer FPN (VT-FPN) and the PVT-FPN builders (counterpart
of ``slenderobjdet_tpu/models/backbones/vt_fpn.py``).

VT-FPN replaces the FPN's top-down pathway: each level's lateral feature is
summarised into 16 visual tokens by a spatial softmax (``Tokenizer``), the
tokens of all levels attend to each other in a 2-layer, 8-head transformer
(``TokenTransformer``, Flax ``nn.SelfAttention`` semantics), and every
level's pixels attend to the refined tokens (``Projector``), added back as a
residual before the 3x3 output conv. P6 and P7 are 3x3/2 convs from the
output P5. Convolutions see NCHW tensors (``channels_last`` memory); tokens
are (B, L, C).

Four builders: RetinaNet's FPN over PVT or PVTv2 (P6/P7 from ``pvt4``) and
the VT-FPN over a ResNet, registered under two names that build the same
network, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from ..layers import Conv2d, LayerNorm, Linear, gelu
from .pvt import PVT_DIMS, build_pvt_backbone, to_tokens
from .resnet import resnet_from_cfg, resnet_output_channels


class Tokenizer(nn.Module):
    """(B, C, H, W) -> (B, L, C): a 1x1 conv scores every position for each
    of L tokens, a softmax over the positions in float32, then each token is
    the weighted sum of the pixels."""

    def __init__(self, channels: int, num_tokens: int = 16):
        super().__init__()
        self.attn = Conv2d(channels, num_tokens, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(to_tokens(self.attn(x)).float(), dim=1).to(x.dtype)
        return torch.matmul(attn.transpose(1, 2), to_tokens(x))


class SelfAttention(nn.Module):
    """Flax ``nn.SelfAttention`` (no dropout): per-head query, key and value
    projections with biases (``Linear(C, H*D)``, the Flax (C, H, D) kernels
    flattened), the query divided by sqrt(D) in the compute dtype before the
    product, the softmax in the compute dtype, then the output projection
    from the H*D concatenated heads."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(channels, channels)
        self.key = Linear(channels, channels)
        self.value = Linear(channels, channels)
        self.out = Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.num_heads

        def heads(t):
            return t.reshape(b, n, self.num_heads, d).transpose(1, 2)

        q = heads(self.query(x))
        q = q / q.new_tensor(math.sqrt(d))
        attn = torch.softmax(torch.matmul(q, heads(self.key(x)).transpose(-2, -1)), dim=-1)
        out = torch.matmul(attn, heads(self.value(x)))
        return self.out(out.transpose(1, 2).reshape(b, n, c))


class TokenTransformer(nn.Module):
    """Pre-norm transformer layers over the tokens: self-attention, then a
    2C GELU MLP, each with a residual."""

    def __init__(self, channels: int, num_layers: int = 2, num_heads: int = 8):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(channels))
            self.add_module(f"attn{i}", SelfAttention(channels, num_heads))
            self.add_module(f"ln2_{i}", LayerNorm(channels))
            self.add_module(f"fc1_{i}", Linear(channels, 2 * channels))
            self.add_module(f"fc2_{i}", Linear(2 * channels, channels))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            def sub(name):
                return getattr(self, f"{name}{i}")

            tokens = tokens + sub("attn")(sub("ln1_")(tokens))
            tokens = tokens + sub("fc2_")(gelu(sub("fc1_")(sub("ln2_")(tokens))))
        return tokens


class Projector(nn.Module):
    """The pixels of one level attend to the tokens; the result is added to
    the level. Scores accumulate in float32, scaled after the product; the
    softmax runs in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.q = Linear(channels, channels)
        self.k = Linear(channels, channels)
        self.v = Linear(channels, channels)

    def forward(self, x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.q(to_tokens(x))
        k = self.k(tokens)
        attn = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, self.v(tokens))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VTFPN(nn.Module):
    """Laterals, tokens, transformer, projectors and 3x3 outputs over the
    bottom-up features ``in_features`` (strides ``in_strides``), then P6 and
    P7 from the output P5."""

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str],
                 in_channels: Sequence[int], in_strides: Sequence[int],
                 out_channels: int = 256, num_tokens: int = 16):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(cin, out_channels, 1))
            self.add_module(f"tokenizer{i}", Tokenizer(out_channels, num_tokens))
        self.transformer = TokenTransformer(out_channels)
        for i in range(len(in_channels)):
            self.add_module(f"projector{i}", Projector(out_channels))
            self.add_module(f"output{i}", Conv2d(out_channels, out_channels, 3, padding=1))
        self.top_p6 = Conv2d(out_channels, out_channels, 3, 2, 1)
        self.top_p7 = Conv2d(out_channels, out_channels, 3, 2, 1)
        self.start_stage = int(in_strides[0]).bit_length() - 1
        self.strides = {f"p{k}": 2 ** k for k in range(
            self.start_stage, self.start_stage + len(in_channels) + 2)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        n = len(self.in_features)
        laterals = [getattr(self, f"lateral{i}")(bottom_up[f])
                    for i, f in enumerate(self.in_features)]
        tokens = torch.cat([getattr(self, f"tokenizer{i}")(lat)
                            for i, lat in enumerate(laterals)], dim=1)
        tokens = self.transformer(tokens)
        outputs = {}
        for i, lat in enumerate(laterals):
            p = getattr(self, f"projector{i}")(lat, tokens)
            outputs[f"p{self.start_stage + i}"] = getattr(self, f"output{i}")(p)
        last = self.start_stage + n - 1
        p6 = self.top_p6(outputs[f"p{last}"])
        outputs[f"p{last + 1}"] = p6
        outputs[f"p{last + 2}"] = self.top_p7(torch.relu(p6))
        return outputs


def _pvt_fpn(cfg, v2: bool):
    from .fpn import FPN

    in_features = tuple(cfg.MODEL.FPN.IN_FEATURES)
    return FPN(
        bottom_up=build_pvt_backbone(cfg, v2=v2),
        in_features=in_features,
        in_channels=[PVT_DIMS[int(f[-1]) - 1] for f in in_features],
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        top_block="p6p7_res5",       # P6 / P7 from pvt4
    )


def build_retinanet_pvt_fpn_backbone(cfg) -> nn.Module:
    """PVT bottom-up and RetinaNet's FPN, P6 / P7 from the last PVT stage."""
    return _pvt_fpn(cfg, v2=False)


def build_retinanet_pvtv2_fpn_backbone(cfg) -> nn.Module:
    """The same over PVTv2."""
    return _pvt_fpn(cfg, v2=True)


def build_retinanet_resnet_vt_fpn(cfg) -> VTFPN:
    """VT-FPN over ``MODEL.RESNETS``, P6 / P7 from the output P5; the JAX
    package registers it under this name and
    ``build_retinanet_resnet_vt_fpn_backbone_use_p5``."""
    from .fpn import FEATURE_STRIDES

    in_features = tuple(cfg.MODEL.FPN.IN_FEATURES)
    chans = resnet_output_channels(cfg.MODEL.RESNETS.DEPTH,
                                   cfg.MODEL.RESNETS.RES2_OUT_CHANNELS)
    return VTFPN(resnet_from_cfg(cfg), in_features, [chans[f] for f in in_features],
                 [FEATURE_STRIDES[f] for f in in_features], cfg.MODEL.FPN.OUT_CHANNELS)
