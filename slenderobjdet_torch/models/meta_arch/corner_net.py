"""CornerNet (counterpart of ``slenderobjdet_tpu/models/meta_arch/corner_net.py``:
``CornerHead``, ``CornerNetModule``, ``render_corner_targets``,
``corner_focal_loss`` and ``CornerNet``).

The Stacked-Hourglass trunk (``backbones/hourglass.py``) feeds, for each
feature of ``MODEL.CORNER_NET.IN_FEATURES`` (one a stack), a top-left and a
bottom-right ``CornerHead``: two 3x3 ``ConvBNRelu`` of 128 channels, corner
pooling (``ops/corner_pool.py``: the hand-written kernel on CUDA tensors),
3x3 and 1x1 ``ConvBNRelu`` without ReLU summed, a 3x3 ``ConvBNRelu``, then
heat (a class each, bias at the 0.1 prior, ``-log(9)``), tag (1) and offset
(2: x, y) outputs, each a 3x3 conv, ReLU and 1x1 conv, in float32.

Training supervises every stack (intermediate supervision): the focal loss
on gaussian corner heatmaps (``render_corner_targets``), the pull and push
associative-embedding losses on the tags at the gt corners and the L1 loss
on the sub-stride corner offsets. ``num_pos`` and the push term's ``num_pos
* (num_pos - 1)`` count the global batch (``parallel.multihost``).

Inference reads the last stack's heads only (the first stack's are not
computed): sigmoid heatmaps, 3x3 max-pool NMS, ``pair_top_k`` of K = 100
corners a side, every TL x BR pair of one class with the BR right of and
below the TL and tags closer than 0.5, the top ``4 * max_dets`` pair scores,
the 0.05 gate, class-aware NMS at 0.5 (``ops/nms.py:cuda_batched_nms``: the
hand-written kernel on CUDA tensors) to ``max_dets``, divided by the scale
and clipped to the original image.

Heads return NHWC: heat (B, H, W, C), tag (B, H, W), offset (B, H, W, 2).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.corner_pool import br_pool, tl_pool
from ...ops.nms import cuda_batched_nms
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_normalizer, process_share
from ...structures import boxes as box_ops
from ..backbones.fpn import build_backbone
from ..backbones.hourglass import ConvBNRelu
from ..layers import Conv2d, init_detector_weights, prior_bias, uses_batch_statistics

HEAT_PRIOR = 0.1
STRIDE = 4
TOPK_CORNERS = 100


class CornerHead(nn.Module):
    """TL or BR branch: corner pool, then the heat, tag and offset convs."""

    def __init__(self, channels: int, num_classes: int, corner: str, norm: str = "BN"):
        super().__init__()
        c = channels
        self.corner = corner
        self.pool_conv1 = ConvBNRelu(c, 128, 3, 1, norm)
        self.pool_conv2 = ConvBNRelu(c, 128, 3, 1, norm)
        self.pool_out = ConvBNRelu(128, c, 3, 1, norm, relu=False)
        self.skip = ConvBNRelu(c, c, 1, 1, norm, relu=False)
        self.feat = ConvBNRelu(c, c, 3, 1, norm)
        for name, out in (("heat", num_classes), ("tag", 1), ("offset", 2)):
            self.add_module(f"{name}_conv", Conv2d(c, c, 3, padding=1))
            self.add_module(f"{name}_out", Conv2d(c, out, 1))

    def _out(self, name: str, feat: torch.Tensor) -> torch.Tensor:
        h = F.relu(getattr(self, f"{name}_conv")(feat))
        return getattr(self, f"{name}_out")(h).float().permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor):
        p1, p2 = self.pool_conv1(x), self.pool_conv2(x)
        pooled = tl_pool(p1, p2) if self.corner == "tl" else br_pool(p1, p2)
        feat = F.relu(self.pool_out(pooled) + self.skip(x))
        feat = self.feat(feat)
        return self._out("heat", feat), self._out("tag", feat)[..., 0], self._out("offset", feat)


def render_corner_targets(hw, stride, gt_boxes, gt_classes, gt_valid, num_classes):
    """Gaussian-splatted corner heatmaps and the gt corners on the output
    grid, for a batch: gt_boxes (B, G, 4), gt_classes (B, G), gt_valid (B,
    G) -> (tl_heat (B, H, W, C), br_heat, tl_pos (B, G, 2) float (y, x),
    br_pos).

    A class's heat is the max over its valid gts of their gaussians; it is
    formed by ``scatter_reduce(amax)`` into a zero plane by class, which
    gives the JAX package's max over (H, W, G, C) products with a one-hot
    (g >= 0, g * 1 == g and g * 0 == +0) without the (H, W, G, C) tensor."""
    H, W = hw
    B, G = gt_classes.shape
    dev = gt_boxes.device
    x1 = gt_boxes[..., 0] / stride
    y1 = gt_boxes[..., 1] / stride
    x2 = gt_boxes[..., 2] / stride
    y2 = gt_boxes[..., 3] / stride
    w = x2 - x1
    h = y2 - y1
    # gaussian radius ~ 1/3 of the shorter side (the JAX package's rule); a
    # third is taken as a product with float32(1/3), as XLA compiles the
    # JAX package's division by the constant 3
    third = 1.0 / 3.0
    radius = torch.clamp(torch.minimum(w, h) * third, min=1.0)
    sigma2 = (2 * radius * third) ** 2 / 4.0
    denom = torch.clamp(2 * sigma2, min=1e-6)[:, None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
    keep = gt_valid & (gt_classes >= 0) & (gt_classes < num_classes)
    index = torch.where(keep, gt_classes, 0).long()[:, None, :].expand(B, H * W, G)

    def splat(cx, cy):
        d2 = (xs - cx[:, None, None, :]) ** 2 + (ys - cy[:, None, None, :]) ** 2
        g = torch.exp(-d2 / denom)
        g = torch.where(keep[:, None, None, :], g, 0.0).reshape(B, H * W, G)
        heat = torch.zeros((B, H * W, num_classes), dtype=torch.float32, device=dev)
        heat.scatter_reduce_(2, index, g, "amax", include_self=True)
        return heat.reshape(B, H, W, num_classes)

    tl_pos = torch.stack([torch.clamp(y1, 0, H - 1), torch.clamp(x1, 0, W - 1)], -1)
    br_pos = torch.stack([torch.clamp(y2, 0, H - 1), torch.clamp(x2, 0, W - 1)], -1)
    return splat(x1, y1), splat(x2, y2), tl_pos, br_pos


def corner_focal_loss(pred_logits, gt_heat, num_pos):
    """Penalty-reduced pixelwise focal loss (CornerNet eq. 1), the sum over
    every location and class divided by ``num_pos``."""
    p = torch.sigmoid(pred_logits)
    pos = gt_heat >= 0.999
    pos_loss = -torch.log(torch.clamp(p, min=1e-6)) * (1 - p) ** 2
    neg_loss = -torch.log(torch.clamp(1 - p, min=1e-6)) * p ** 2 * (1 - gt_heat) ** 4
    return torch.where(pos, pos_loss, neg_loss).sum() / num_pos


def _gather_at(maps: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """maps (B, H, W, ...) at pos (B, G, 2) float (y, x), truncated to
    integers and clipped: (B, G, ...)."""
    B, H, W = maps.shape[:3]
    iy = torch.clamp(pos[..., 0].to(torch.int32), 0, H - 1).long()
    ix = torch.clamp(pos[..., 1].to(torch.int32), 0, W - 1).long()
    flat = maps.reshape(B, H * W, *maps.shape[3:])
    idx = (iy * W + ix).reshape(B, -1, *([1] * (flat.ndim - 2)))
    return torch.gather(flat, 1, idx.expand(-1, -1, *flat.shape[2:]))


class CornerNet(nn.Module):
    """Config-driven CornerNet: ``loss(batch)`` and ``predict(batch)``."""

    def __init__(self, cfg):
        super().__init__()
        self.int8_predict = cfg.TPU.INT8_PREDICT
        c = cfg.MODEL.CORNER_NET
        self.dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                      else torch.float32)
        self.num_classes = c.NUM_CLASSES
        self.in_features = tuple(c.IN_FEATURES)
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.backbone = build_backbone(cfg)
        self.size_divisibility = self.backbone.size_divisibility
        channels = cfg.MODEL.HOURGLASS.CHANNELS_BLOCK[0]
        for i, _ in enumerate(self.in_features):
            self.add_module(f"tl_head{i}", CornerHead(channels, self.num_classes, "tl", c.NORM))
            self.add_module(f"br_head{i}", CornerHead(channels, self.num_classes, "br", c.NORM))
        self.register_buffer("pixel_mean", torch.tensor(cfg.MODEL.PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.MODEL.PIXEL_STD), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights``, then every heat bias at the 0.1 prior."""
        init_detector_weights(self, generator)
        for i, _ in enumerate(self.in_features):
            for side in ("tl", "br"):
                getattr(self, f"{side}_head{i}").heat_out.bias.fill_(prior_bias(HEAT_PRIOR))

    def forward(self, images: torch.Tensor, stacks=None) -> List[Tuple]:
        """uint8 (B, H, W, 3) images -> for each stack in ``stacks`` (every
        stack when None), ((tl heat, tag, offset), (br heat, tag, offset)).
        The image is normalised in float32 and then cast to the compute
        dtype."""
        x = (images.float() - self.pixel_mean) / self.pixel_std
        feats = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        stacks = range(len(self.in_features)) if stacks is None else stacks
        return [(getattr(self, f"tl_head{i}")(feats[self.in_features[i]]),
                 getattr(self, f"br_head{i}")(feats[self.in_features[i]])) for i in stacks]

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4),
        "gt_classes": (B, G), "gt_valid": (B, G)}. Returns the total and
        {"loss_heat", "loss_pull", "loss_push", "loss_offset", "num_pos"}."""
        dev = self.pixel_mean.device
        outs = self(torch.as_tensor(batch["image"], device=dev))
        H, W = outs[-1][0][0].shape[1:3]
        gt_boxes = torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev)
        gt_classes = torch.as_tensor(batch["gt_classes"], device=dev)
        gt_valid = torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev)
        G = gt_classes.shape[1]
        with torch.no_grad():
            tl_heat_t, br_heat_t, tl_pos, br_pos = render_corner_targets(
                (H, W), STRIDE, gt_boxes, gt_classes, gt_valid, self.num_classes)

        num_pos, pos_share = global_normalizer(gt_valid.sum().float(), 1.0)
        push_share = process_share(torch.clamp(num_pos * (num_pos - 1), min=1.0))
        pair_valid = gt_valid[:, :, None] & gt_valid[:, None, :]
        pair_valid &= ~torch.eye(G, dtype=torch.bool, device=dev)
        tl_frac = (tl_pos - torch.floor(tl_pos)).flip(-1)      # (y, x) -> (x, y)
        br_frac = (br_pos - torch.floor(br_pos)).flip(-1)
        total_heat = total_pull = total_push = total_off = 0.0
        for (tl_heat, tl_tag, tl_off), (br_heat, br_tag, br_off) in outs:
            total_heat = total_heat + corner_focal_loss(tl_heat, tl_heat_t, pos_share)
            total_heat = total_heat + corner_focal_loss(br_heat, br_heat_t, pos_share)

            ttag = _gather_at(tl_tag[..., None], tl_pos)[..., 0]     # (B, G)
            btag = _gather_at(br_tag[..., None], br_pos)[..., 0]
            mean = (ttag + btag) / 2
            pull = torch.where(gt_valid, (ttag - mean) ** 2 + (btag - mean) ** 2, 0.0)
            total_pull = total_pull + pull.sum() / pos_share

            # push: the means of different objects separate
            dist = torch.abs(mean[:, :, None] - mean[:, None, :])
            push = torch.where(pair_valid, torch.clamp(1.0 - dist, min=0.0), 0.0)
            total_push = total_push + push.sum() / push_share

            off_l1 = (torch.abs(_gather_at(tl_off, tl_pos) - tl_frac)
                      + torch.abs(_gather_at(br_off, br_pos) - br_frac))
            total_off = total_off + torch.where(gt_valid[..., None], off_l1, 0.0).sum() \
                / pos_share

        total = total_heat + 0.1 * total_pull + 0.1 * total_push + total_off
        return total, {"loss_heat": total_heat, "loss_pull": total_pull,
                       "loss_push": total_push, "loss_offset": total_off,
                       "num_pos": num_pos}

    # ---------------------------------------------------------- inference
    def _corners(self, heat, tag, off):
        """One side's top K corners: scores, classes, x, y and tags (B, K)."""
        B, H, W, C = heat.shape
        p = torch.sigmoid(heat)
        pooled = F.max_pool2d(p.permute(0, 3, 1, 2), 3, stride=1, padding=1)
        p = torch.where(p == pooled.permute(0, 2, 3, 1), p, 0.0)
        scores, loc, cls = pair_top_k(p.reshape(B, H * W, C), TOPK_CORNERS)
        iy = (loc // W).float()
        ix = (loc % W).float()
        t = torch.gather(tag.reshape(B, H * W), 1, loc)
        o = torch.gather(off.reshape(B, H * W, 2), 1, loc[..., None].expand(-1, -1, 2))
        return scores, cls, (ix + o[..., 0]) * STRIDE, (iy + o[..., 1]) * STRIDE, t

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,), "orig_size":
        (B, 2)}. Returns boxes (B, D, 4) in original image coordinates,
        scores (B, D), classes (B, D) int32 and valid (B, D) bool."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            (tl, br), = self(images, stacks=[len(self.in_features) - 1])
        return self.detections(tl, br, torch.as_tensor(batch["scale"], device=dev),
                               torch.as_tensor(batch["orig_size"], device=dev))

    def detections(self, tl, br, scale, orig_size) -> Dict[str, torch.Tensor]:
        """The decode of ``predict`` from the last stack's head outputs (tl,
        br: (heat, tag, offset) each), the scales (B,) and original sizes
        (B, 2)."""
        boxes, top, classes, valid = self.candidates(tl, br)
        keep_idx, keep_valid = cuda_batched_nms(boxes, top, classes, 0.5, self.max_dets,
                                                valid=valid)
        keep = keep_idx.long()
        kept = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
        hw = orig_size.float()
        kept = box_ops.clip(kept / scale.float()[:, None, None], hw[:, 0:1], hw[:, 1:2])
        return {"boxes": kept, "scores": torch.gather(top, 1, keep),
                "classes": torch.gather(classes, 1, keep), "valid": keep_valid}

    def candidates(self, tl, br):
        """The NMS's input: the top ``4 * max_dets`` TL x BR pairs' boxes (B,
        N, 4), scores (B, N), classes (B, N) int32 and the 0.05 gate (B,
        N)."""
        ts, tc, tx, ty, ttag = self._corners(*tl)
        bs, bc, bx, by, btag = self._corners(*br)
        B, K = ts.shape

        # every TL x BR pair: one class, the BR right of and below the TL,
        # tags closer than 0.5
        score = (ts[:, :, None] + bs[:, None, :]) / 2
        valid = ((tc[:, :, None] == bc[:, None, :])
                 & (bx[:, None, :] > tx[:, :, None]) & (by[:, None, :] > ty[:, :, None])
                 & (torch.abs(ttag[:, :, None] - btag[:, None, :]) < 0.5))
        score = torch.where(valid, score, 0.0)
        top, idx = torch.topk(score.reshape(B, K * K), min(self.max_dets * 4, K * K), dim=1)
        ti, bi = idx // K, idx % K
        boxes = torch.stack([torch.gather(tx, 1, ti), torch.gather(ty, 1, ti),
                             torch.gather(bx, 1, bi), torch.gather(by, 1, bi)], -1)
        return boxes, top, torch.gather(tc, 1, ti), top > 0.05
