"""Pyramid Vision Transformer backbones, PVT (v1) and PVTv2 (counterpart of
``slenderobjdet_tpu/models/backbones/pvt.py``).

Four stages of a patch embedding (a conv, then a LayerNorm over the tokens)
and spatial-reduction attention blocks, outputs ``pvt1``..``pvt4`` at
strides 4/8/16/32, depths by ``MODEL.PVT.DEPTH``. Convolutions see NCHW
tensors (``channels_last`` memory); the blocks work on (B, N, C) tokens,
which are the same memory viewed as NHWC. Module and parameter names follow
the Flax tree, which keeps ``checkpoint/bridge.py`` a renaming.

PVT v1 adds a learned 7x7 position embedding to every stage, resized to the
stage's grid in the graph by ``resize_pos_embed`` (differentiable to the
7x7 parameter). PVTv2 has overlapping patch embeddings (7x7/4 pad 3, then
3x3/2 pad 1) and a depthwise 3x3 conv between the MLP's layers instead.

The attention is plain matmuls and a softmax in the JAX package's dtypes:
scores accumulated and kept in float32, scaled after the product, the
softmax in float32, the probabilities cast to the compute dtype before the
product with the values.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, LayerNorm, Linear, gelu

PVT_DEPTHS = {
    "tiny": (2, 2, 2, 2),
    "small": (3, 4, 6, 3),
    "medium": (3, 4, 18, 3),
    "large": (3, 8, 27, 3),
}
PVT_DIMS = (64, 128, 320, 512)
PVT_HEADS = (1, 2, 5, 8)
PVT_MLP_RATIOS = (8, 8, 4, 4)
PVT_SR_RATIOS = (8, 4, 2, 1)
PVT_STRIDES = {"pvt1": 4, "pvt2": 8, "pvt3": 16, "pvt4": 32}
POS_EMBED_GRID = (7, 7)


def resize_pos_embed(pos: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(1, h, w, C) -> (1, H, W, C) by ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, and a triangle kernel widened by the scale where the
    grid shrinks (antialiasing), which is torch's antialiased bilinear."""
    x = pos.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax's "SAME" padding for a k x k conv of stride s over an NCHW x
    (nothing where the sides are multiples of s and k == s, as in a padded
    detector batch)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B, H*W, C)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


def to_grid(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H*W, C) -> NCHW (``channels_last`` memory)."""
    b, _, c = x.shape
    return x.reshape(b, hw[0], hw[1], c).permute(0, 3, 1, 2)


class SRAttention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens
    reduced by an sr x sr conv of stride sr (and a LayerNorm) where
    ``sr_ratio`` > 1."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = LayerNorm(dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.num_heads
        q = self.q(x)
        if self.sr_ratio > 1:
            xr = self.sr(_same_pad(to_grid(x, hw), self.sr_ratio, self.sr_ratio))
            xr = self.sr_norm(to_tokens(xr))
        else:
            xr = x
        k, v = self.kv(xr).chunk(2, dim=-1)

        def heads(t):
            return t.reshape(b, -1, self.num_heads, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        # bf16 products are exact in float32: the scores of an fp32-accumulated
        # matmul, as the JAX einsum's preferred_element_type gives them
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * d ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class PVTBlock(nn.Module):
    """Pre-norm SR attention and a GELU MLP, each with a residual; PVTv2's
    block (``dwconv``) adds a depthwise 3x3 conv between the MLP's layers."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int,
                 dwconv: bool = False):
        super().__init__()
        hidden = dim * mlp_ratio
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden)
        if dwconv:
            self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        h = self.fc1(self.norm2(x))
        if hasattr(self, "dwconv"):
            h = to_tokens(self.dwconv(to_grid(h, hw)))
        return x + self.fc2(gelu(h))


class PVT(nn.Module):
    """PVT v1 (``v2=False``: 4x4/4 then 2x2/2 patch embeddings and the
    position embeddings) or PVTv2 (``v2=True``). Input NCHW, the normalised
    image in the compute dtype; returns {"pvt1".."pvt4": NCHW}."""

    def __init__(self, depths: Sequence[int] = PVT_DEPTHS["small"],
                 dims: Sequence[int] = PVT_DIMS, num_heads: Sequence[int] = PVT_HEADS,
                 mlp_ratios: Sequence[int] = PVT_MLP_RATIOS,
                 sr_ratios: Sequence[int] = PVT_SR_RATIOS, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.depths = tuple(depths)
        cin = 3
        for i, dim in enumerate(dims):
            s = i + 1
            if v2:
                k, stride, pad = (7, 4, 3) if i == 0 else (3, 2, 1)
            else:
                k, stride, pad = (4, 4, 0) if i == 0 else (2, 2, 0)
            self.add_module(f"patch_embed{s}", Conv2d(cin, dim, k, stride, pad))
            self.add_module(f"embed_norm{s}", LayerNorm(dim))
            if not v2:
                self.register_parameter(f"pos_embed{s}", nn.Parameter(
                    torch.zeros(1, *POS_EMBED_GRID, dim)))
            for j in range(depths[i]):
                self.add_module(f"stage{s}_block{j}", PVTBlock(
                    dim, num_heads[i], mlp_ratios[i], sr_ratios[i], dwconv=v2))
            self.add_module(f"stage_norm{s}", LayerNorm(dim))
            cin = dim

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for i, depth in enumerate(self.depths):
            s = i + 1
            embed = getattr(self, f"patch_embed{s}")
            if not self.v2:
                x = _same_pad(x, embed.kernel_size[0], embed.stride[0])
            x = embed(x)
            hw = tuple(x.shape[2:])
            x = getattr(self, f"embed_norm{s}")(to_tokens(x))
            if not self.v2:
                pos = resize_pos_embed(getattr(self, f"pos_embed{s}"), hw)
                x = x + pos.reshape(1, -1, x.shape[-1]).to(x.dtype)
            for j in range(depth):
                x = getattr(self, f"stage{s}_block{j}")(x, hw)
            x = to_grid(getattr(self, f"stage_norm{s}")(x), hw)
            outputs[f"pvt{s}"] = x
        return outputs


def build_pvt_backbone(cfg, v2: bool = False) -> PVT:
    """The trunk of ``MODEL.PVT`` (``DEPTH``: tiny, small, medium, large)."""
    return PVT(depths=PVT_DEPTHS[cfg.MODEL.PVT.DEPTH], v2=v2)
