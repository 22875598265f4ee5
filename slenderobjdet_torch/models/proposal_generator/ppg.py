"""PointsProposalGenerator (counterpart of
``slenderobjdet_tpu/models/proposal_generator/ppg.py``: ``grid_sample_bilinear``,
``likelihood_loss``, ``PPGHead``, ``PointsProposalGenerator`` and
``_sizes_from_boxes``).

- Head: one shared 3x3 conv + relu, a zero-initialised 1x1 conv to 2P point
  offsets and a 1x1 conv to the in-object logit.
- Points: the raw offsets rescaled as ``exp(raw * stride) - 1`` (stride the
  image width over the level's), added to a ``linspace(0, W - 1, w)`` x
  ``linspace(0, H - 1, h)`` grid and clamped to the image.
- Objectness: the gt size magnitude ``|(w, h)|`` per pixel
  (``batch["size_map"]`` (B, H, W, 2) when given, else rasterised from the
  gt boxes by ``_sizes_from_boxes``), subsampled to each level; 1 where the
  size falls in the level's band (32, 64, 128, ..., doubling to the levels'
  count, the last open), 0 on the background, ignored on other objects;
  sigmoid BCE averaged over the non-ignored cells of the global batch.
- The two likelihood losses enter at the reference's literal zero weight,
  keeping their (dead) gradient path.
- Predict: each location's box the min / max of its points; a level's top
  1000 scores, boxes with a side at most MIN_SIZE scored 0, class-agnostic
  NMS at 0.7 (the reference's constant).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import optax_sigmoid_ce
from ...ops.topk import top_k_by_index
from ...parallel.multihost import global_sum, process_share
from ...structures import boxes as box_ops
from ..backbones.fpn import build_backbone
from ..layers import Conv2d, init_detector_weights, uses_batch_statistics
from ..meta_arch.reppoints import RepPointsModule
from .rpg import proposal_outputs

__all__ = ["grid_sample_bilinear", "likelihood_loss", "PPGHead", "PointsProposalGenerator",
           "sizes_from_boxes"]

# elements of one (gt chunk, H, W) comparison in ``sizes_from_boxes``
SIZE_CHUNK_ELEMENTS = 1 << 26


def grid_sample_bilinear(target: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(align_corners=False)`` with zero padding of one (H, W)
    target at normalised (..., 2) (x, y) coordinates in [-1, 1], written out
    as the JAX package writes it."""
    H, W = target.shape
    x = ((coords[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((coords[..., 1] + 1.0) * H - 1.0) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def fetch(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = torch.clamp(xi, 0, W - 1).long()
        yi = torch.clamp(yi, 0, H - 1).long()
        return torch.where(inb, target[yi, xi], 0.0)

    return (fetch(x0, y0) * (1 - wx) * (1 - wy) + fetch(x0 + 1, y0) * wx * (1 - wy)
            + fetch(x0, y0 + 1) * (1 - wx) * wy + fetch(x0 + 1, y0 + 1) * wx * wy)


def likelihood_loss(target: torch.Tensor, coordinates: torch.Tensor,
                    mask: torch.Tensor = None) -> torch.Tensor:
    """target (B, H, W) distributions, coordinates (B, P, Hf, Wf, 2)
    normalised (x, y) sampling points; (B, P) ``-log(mean likelihood +
    1e-8)``, the likelihoods gated by ``mask`` (B, H, W) when given."""
    out = []
    for b in range(target.shape[0]):
        lk = grid_sample_bilinear(target[b], coordinates[b])         # (P, Hf, Wf)
        if mask is not None:
            lk = lk * grid_sample_bilinear(mask[b].float(), coordinates[b])
        out.append(-torch.log(lk.mean(dim=(1, 2)) + 1e-8))
    return torch.stack(out)


def sizes_from_boxes(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, image_hw) -> torch.Tensor:
    """(B, H, W) size magnitude ``|(x2 - x1, y2 - y1)|`` of the largest valid
    box covering each pixel (0 on the background): the JAX package's
    ``_sizes_from_boxes``, reduced image by image over chunks of gts, so that
    no (B, G, H, W) comparison is held (at B 16, 100 gt and 896 x 1408 it is
    2e9 elements). A max is order-free, so the result is exact."""
    H, W = image_hw
    dev = gt_boxes.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    mag = torch.sqrt(torch.square(gt_boxes[..., 2] - gt_boxes[..., 0])
                     + torch.square(gt_boxes[..., 3] - gt_boxes[..., 1]))     # (B, G)
    chunk = max(1, SIZE_CHUNK_ELEMENTS // (H * W))
    out = torch.zeros((gt_boxes.shape[0], H, W), dtype=torch.float32, device=dev)
    for b in range(gt_boxes.shape[0]):
        for g0 in range(0, gt_boxes.shape[1], chunk):
            bx = gt_boxes[b, g0:g0 + chunk]
            inside = ((xs[None, None, :] >= bx[:, None, None, 0])
                      & (xs[None, None, :] <= bx[:, None, None, 2])
                      & (ys[None, :, None] >= bx[:, None, None, 1])
                      & (ys[None, :, None] <= bx[:, None, None, 3])
                      & gt_valid[b, g0:g0 + chunk, None, None])
            vals = torch.where(inside, mag[b, g0:g0 + chunk, None, None], 0.0)
            out[b] = torch.maximum(out[b], vals.amax(dim=0))
    return out


class PPGHead(nn.Module):
    """``forward(feats)`` -> per-level (B, H, W) logits and (B, H, W, 2P) raw
    offsets, float32."""

    def __init__(self, in_channels: int, num_points: int = 9):
        super().__init__()
        c = in_channels
        self.conv = Conv2d(c, c, 3, padding=1)
        self.offsets = Conv2d(c, 2 * num_points, 1)
        self.in_object_logits = Conv2d(c, 1, 1)

    def forward(self, feats: List[torch.Tensor]):
        logits, raw_offsets = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.in_object_logits(t).float()[:, 0])
            raw_offsets.append(self.offsets(t).float().permute(0, 2, 3, 1))
        return logits, raw_offsets


class PointsProposalGenerator(RepPointsModule):
    """Proposal-only detector on dense point-set proposals."""

    SIZE_BANDS = (32.0, 64.0, 128.0, -1.0)

    def __init__(self, cfg):
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        pg = cfg.MODEL.PROPOSAL_GENERATOR
        in_features = list(pg.IN_FEATURES)
        if in_features == ["p5"]:            # unset default: the RPN's features
            in_features = list(cfg.MODEL.RPN.IN_FEATURES)
        backbone = build_backbone(cfg)
        super().__init__(backbone, PPGHead(cfg.MODEL.FPN.OUT_CHANNELS, pg.NUM_POINTS),
                         in_features, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, dtype)
        self.num_points = pg.NUM_POINTS
        self.nms_thresh = 0.7
        self.min_size = pg.MIN_SIZE
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.strides = [backbone.strides[f] for f in self.in_features]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights``; the offsets conv at 0."""
        init_detector_weights(self, generator)
        self.head.offsets.weight.zero_()

    def coordinates(self, raw_offsets, image_hw):
        """Per level (B, h, w, P, 2) point coordinates in image pixels."""
        H, W = image_hw
        coords = []
        for off in raw_offsets:
            b, h, w, _ = off.shape
            off = (torch.exp(off * (W / w)) - 1.0).reshape(b, h, w, self.num_points, 2)
            xs = torch.linspace(0.0, W - 1.0, w, device=off.device)
            ys = torch.linspace(0.0, H - 1.0, h, device=off.device)
            grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (h, w, 2)
            pts = off + grid[None, :, :, None, :]
            coords.append(torch.stack([torch.clamp(pts[..., 0], 0, W - 1),
                                       torch.clamp(pts[..., 1], 0, H - 1)], dim=-1))
        return coords

    @staticmethod
    def proposal_boxes(coords):
        """Per level (B, h*w, 4): the min / max over each location's points."""
        out = []
        for pts in coords:
            b, h, w = pts.shape[:3]
            px, py = pts[..., 0], pts[..., 1]
            out.append(torch.stack([px.amin(-1), py.amin(-1), px.amax(-1), py.amax(-1)],
                                   dim=-1).reshape(b, h * w, 4))
        return out

    def bands(self, num_levels):
        bands = list(self.SIZE_BANDS)
        while len(bands) < num_levels:
            bands.insert(-1, bands[-2] * 2)
        return bands

    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image", "gt_boxes", "gt_valid"} and optionally
        "size_map" (B, H, W, 2). Returns the total loss and per level
        ``objectness_loss_{l}``, ``border_likely_loss_{l}``,
        ``center_likely_loss_{l}`` (both 0), and ``num_pos`` (object
        pixels)."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        H, W = images.shape[1:3]
        logits_l, raw_l = self(images)
        coords_l = self.coordinates(raw_l, (H, W))
        if "size_map" in batch:
            size_map = torch.as_tensor(batch["size_map"], dtype=torch.float32, device=dev)
            gt_sizes = torch.sqrt(torch.sum(size_map ** 2, dim=-1))
        else:
            gt_sizes = sizes_from_boxes(
                torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
                torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev), (H, W))

        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        lower = 0.0
        bands = self.bands(len(logits_l))
        for lvl, logits in enumerate(logits_l):
            upper = bands[lvl] if bands[lvl] > 0 else 102400.0
            h, w = logits.shape[1:]
            g = gt_sizes[:, ::max(H // h, 1), ::max(W // w, 1)][:, :h, :w]
            base = (g == 0).float() - 1.0                   # background 0, object -1
            in_band = ((g > lower) & (g <= upper)).float()
            gt_logit = in_band * 2.0 + base                 # background 0, band 1, else -1
            lower = upper
            cared = gt_logit >= 0
            bce = optax_sigmoid_ce(logits, torch.clamp(gt_logit, 0.0, 1.0))
            share = process_share(global_sum(cared.sum()).float() + 1e-5)
            obj = torch.where(cared, bce, 0.0).sum() / share
            metrics[f"objectness_loss_{lvl}"] = obj
            pts = coords_l[lvl]
            metrics[f"border_likely_loss_{lvl}"] = torch.sum(pts) * 0.0
            metrics[f"center_likely_loss_{lvl}"] = torch.sum(
                pts[:, :, :, self.num_points // 2]) * 0.0
            total = total + obj + metrics[f"border_likely_loss_{lvl}"]
        metrics["num_pos"] = global_sum((gt_sizes > 0).sum())
        return total, metrics

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """As ``RepPointsGenerator.predict``."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        logits_l, raw_l = self(images)
        return self.postprocess(logits_l, raw_l, tuple(images.shape[1:3]),
                                torch.as_tensor(batch["scale"], device=dev),
                                torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, raw_l, image_hw):
        """Per level the top 1000 point-set boxes by sigmoid score,
        concatenated, scores 0 where a side is at most MIN_SIZE."""
        cb, cs = [], []
        for logits, boxes in zip(logits_l,
                                 self.proposal_boxes(self.coordinates(raw_l, image_hw))):
            scores = torch.sigmoid(logits).reshape(logits.shape[0], -1)
            top, idx = top_k_by_index(scores, min(1000, scores.shape[1]))
            cb.append(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
            cs.append(top)
        boxes, scores = torch.cat(cb, dim=1), torch.cat(cs, dim=1)
        return boxes, torch.where(box_ops.nonempty(boxes, self.min_size), scores, 0.0)

    def postprocess(self, logits_l, raw_l, image_hw, scale, orig_size):
        boxes, scores = self.candidates(logits_l, raw_l, image_hw)
        return proposal_outputs(boxes, scores, self.nms_thresh, self.max_dets, scale,
                                orig_size)
