"""RepPointsGenerator: the RepPoints init stage as a proposal network
(counterpart of ``slenderobjdet_tpu/models/proposal_generator/rpg.py``:
``RepPointsInitHead`` and ``RepPointsGenerator``).

- Head: two towers of 3 x (3x3 conv + trainable ``BatchNorm`` + relu); the
  objectness tower ends in a 3x3 conv to 1 logit, the deltas tower in a 1x1
  conv to 2P point offsets in image pixels; a learnt 2-vector
  ``moment_transfer``. One BatchNorm serves every pyramid level: in a loss
  it normalises each level by that level's own batch statistics and updates
  its running statistics level by level, P3 first, as Flax does.
- Boxes: ``points2bbox(..., method="moment")`` at point stride 1 (the
  gradient-safe std) around centres at ``(ix, iy) * stride``.
- Targets by ``MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE``: ``inside`` (stride
  cells inside the box) or else the nearest point (``pos_num`` 1).
- Loss: focal (alpha 0.25, gamma 2) with OHEM negatives, the positives'
  mean plus the mean of the 3 x #pos largest negative losses, and
  smooth-L1 (beta 0.11) of the boxes over 4 x stride averaged over the
  positives' coordinates, both times ``MODEL.RPN.LOSS_WEIGHT``. Counts are
  those of the global batch, and the negatives are ranked over it: in a
  process group the ranking gathers every process's negatives.
- Predict: a level's top 1000 scores (ties to the lower index, as
  ``jax.lax.top_k``), boxes narrower or lower than ``MIN_SIZE`` scored 0 (not
  removed), class-agnostic NMS at ``RPN.NMS_THRESH`` into
  ``TEST.DETECTIONS_PER_IMAGE`` slots (on CUDA tensors the hand-written
  kernel), rescaled and clipped; class 0, with the same tensors under
  ``proposals`` / ``proposal_scores`` / ``proposal_valid``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.nms import cuda_nms
from ...ops.topk import top_k_by_index
from ...parallel.multihost import (gather_over_processes, global_sum, process_index,
                                   process_share)
from ...structures import boxes as box_ops
from ..backbones.fpn import build_backbone
from ..layers import BatchNorm, Conv2d, init_detector_weights, uses_batch_statistics
from ..meta_arch.reppoints import (RepPointsModule, inside_assign, point_grid, points2bbox,
                                   rep_points_assign)

__all__ = ["RepPointsInitHead", "RepPointsGenerator", "ohem_negative_sum",
           "proposal_outputs"]


class RepPointsInitHead(nn.Module):
    """``forward(feats)`` -> per-level (B, H*W) logits and (B, H*W, 2P)
    offsets, float32, row-major (h, w), and ``moment_transfer``."""

    def __init__(self, in_channels: int, num_points: int = 9):
        super().__init__()
        c = in_channels
        self.num_points = num_points
        for prefix in ("objectness", "deltas"):
            for i in range(3):
                self.add_module(f"{prefix}_conv{i}", Conv2d(c, c, 3, padding=1))
                self.add_module(f"{prefix}_norm{i}", BatchNorm(c))
        self.objectness_out = Conv2d(c, 1, 3, padding=1)
        self.deltas_out = Conv2d(c, 2 * num_points, 1)
        self.moment_transfer = nn.Parameter(torch.zeros(2))

    def tower(self, prefix, x):
        for i in range(3):
            x = F.relu(getattr(self, f"{prefix}_norm{i}")(getattr(self, f"{prefix}_conv{i}")(x)))
        return x

    def forward(self, feats: List[torch.Tensor]):
        logits, deltas = [], []
        for f in feats:
            b, _, h, w = f.shape
            t1 = self.tower("objectness", f)
            t2 = self.tower("deltas", f)
            logits.append(self.objectness_out(t1).float().reshape(b, h * w))
            deltas.append(self.deltas_out(t2).float().permute(0, 2, 3, 1)
                          .reshape(b, h * w, 2 * self.num_points))
        return logits, deltas, self.moment_transfer


def ohem_negative_sum(losses: torch.Tensor, pos: torch.Tensor, neg_count: torch.Tensor):
    """The sum of this process's part of the ``neg_count`` largest negative
    losses of the global batch (``losses``, ``pos`` (B, X): this process's
    rows). The ranking is the JAX package's: an ascending stable sort of the
    flattened joined batch, reversed, so that among equal losses at the cut
    the higher index is picked; positives rank last (-inf)."""
    neg = torch.where(pos, -torch.inf, losses).reshape(-1)
    joined = gather_over_processes(neg)
    order = torch.sort(joined, stable=True)[1].flip(0)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    start = process_index() * neg.numel()
    picked = (rank[start:start + neg.numel()] < neg_count) & torch.isfinite(neg)
    return torch.where(picked, neg, 0.0).sum()


def proposal_outputs(boxes, scores, nms_thresh: float, max_dets: int, scale,
                     orig_size) -> Dict[str, torch.Tensor]:
    """Class-agnostic NMS of (B, N, 4) boxes by (B, N) scores (on CUDA
    tensors the hand-written kernel), the kept boxes rescaled by ``scale``
    (B,) and clipped to ``orig_size`` (B, 2); detections of class 0, also
    under the proposal keys."""
    keep_idx, keep_valid = cuda_nms(boxes, scores, nms_thresh, max_dets)
    keep = keep_idx.long()
    orig = orig_size.float()
    kb = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
    kb = box_ops.clip(kb / scale.float()[:, None, None], orig[:, 0:1], orig[:, 1:2])
    ks = torch.gather(scores, 1, keep)
    return {"boxes": kb, "scores": ks, "classes": torch.zeros_like(keep_idx),
            "valid": keep_valid, "proposals": kb, "proposal_scores": ks,
            "proposal_valid": keep_valid}


class RepPointsGenerator(RepPointsModule):
    """Proposal-only detector over the RepPoints init stage."""

    def __init__(self, cfg):
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        pg = cfg.MODEL.PROPOSAL_GENERATOR
        backbone = build_backbone(cfg)
        head = RepPointsInitHead(cfg.MODEL.FPN.OUT_CHANNELS, pg.NUM_POINTS)
        super().__init__(backbone, head, cfg.MODEL.RPN.IN_FEATURES, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.num_points = pg.NUM_POINTS
        self.sample_mode = pg.SAMPLE_MODE
        self.min_size = pg.MIN_SIZE
        self.nms_thresh = cfg.MODEL.RPN.NMS_THRESH
        self.loss_weight = cfg.MODEL.RPN.LOSS_WEIGHT
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.strides = [backbone.strides[f] for f in self.in_features]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights``; ``moment_transfer`` at 0."""
        init_detector_weights(self, generator)
        self.head.moment_transfer.zero_()

    def decode(self, deltas_l, moment_transfer, image_hw):
        """Per-level (B, L_l, 4) boxes of the per-level offsets."""
        centers_np, counts, _ = point_grid(image_hw, self.strides)
        centers = torch.as_tensor(centers_np, device=deltas_l[0].device)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [points2bbox(d, centers[offsets[i]: offsets[i + 1]], 1.0, "moment",
                            moment_transfer) for i, d in enumerate(deltas_l)]

    @torch.no_grad()
    def targets(self, gt_boxes, gt_valid, image_hw):
        """Objectness (B, L) bool and matched gt boxes (B, L, 4), image by
        image, by SAMPLE_MODE."""
        dev = gt_boxes.device
        centers_np, counts, lvls_np = point_grid(image_hw, self.strides)
        centers = torch.as_tensor(centers_np, device=dev)
        lvls = torch.as_tensor(lvls_np, device=dev)
        lvl_min, lvl_max = int(np.log2(self.strides[0])), int(np.log2(self.strides[-1]))
        stride_per_loc = torch.as_tensor(np.concatenate([
            np.full(c, s, np.float32) for c, s in zip(counts, self.strides)]), device=dev)
        out = []
        for b in range(gt_boxes.shape[0]):
            if self.sample_mode == "inside":
                out.append(inside_assign(centers, lvls, stride_per_loc, gt_boxes[b],
                                         gt_valid[b], lvl_min, lvl_max))
            else:
                out.append(rep_points_assign(centers, lvls, gt_boxes[b], gt_valid[b],
                                             lvl_min, lvl_max, pos_num=1))
        obj, boxes = zip(*out)
        return torch.stack(obj), torch.stack(boxes), stride_per_loc

    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4),
        "gt_valid": (B, G)} as numpy arrays or tensors. Returns the total
        loss and {"cls_loss", "localization_loss", "num_pos"}."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        image_hw = tuple(images.shape[1:3])
        logits_l, deltas_l, mt = self(images)
        boxes = torch.cat(self.decode(deltas_l, mt, image_hw), dim=1)
        logits = torch.cat(logits_l, dim=1)                                 # (B, X)
        pos, gt_boxes, stride_per_loc = self.targets(
            torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
            torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev), image_hw)

        cls_all = sigmoid_focal_loss(logits[..., None], pos.float()[..., None],
                                     0.25, 2.0)[..., 0]
        pos_count, neg_total = global_sum(torch.stack([pos.sum(), (~pos).sum()]))
        pos_share = process_share(torch.clamp(pos_count.float(), min=1.0))
        pos_mean = torch.where(pos, cls_all, 0.0).sum() / pos_share
        neg_count = torch.minimum(neg_total, pos_count * 3)
        neg_share = process_share(torch.clamp(neg_count.float(), min=1.0))
        cls_loss = pos_mean + ohem_negative_sum(cls_all, pos, neg_count) / neg_share

        norm = (stride_per_loc * 4.0)[None, :, None]
        safe_gt = torch.where(pos[..., None], gt_boxes, 1.0)
        reg_all = smooth_l1_loss(boxes / norm, safe_gt / norm, 0.11)
        loc_loss = torch.where(pos[..., None], reg_all, 0.0).sum() / (pos_share * 4.0)

        total = (cls_loss + loc_loss) * self.loss_weight
        return total, {"cls_loss": cls_loss * self.loss_weight,
                       "localization_loss": loc_loss * self.loss_weight,
                       "num_pos": pos_count}

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image", "scale", "orig_size"}. Returns boxes (B, D, 4),
        scores (B, D), classes (B, D) int32 (0), valid (B, D) and the same
        under ``proposals``, ``proposal_scores``, ``proposal_valid``."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        logits_l, deltas_l, mt = self(images)
        return self.postprocess(logits_l, deltas_l, mt, tuple(images.shape[1:3]),
                                torch.as_tensor(batch["scale"], device=dev),
                                torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, deltas_l, moment_transfer, image_hw):
        """The NMS's input: per level the top 1000 boxes by sigmoid score,
        concatenated, with scores 0 where a side is at most MIN_SIZE."""
        cb, cs = [], []
        for logits, boxes in zip(logits_l, self.decode(deltas_l, moment_transfer, image_hw)):
            top, idx = top_k_by_index(torch.sigmoid(logits), min(1000, logits.shape[1]))
            cb.append(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
            cs.append(top)
        boxes, scores = torch.cat(cb, dim=1), torch.cat(cs, dim=1)
        wh_ok = box_ops.nonempty(boxes, self.min_size)
        return boxes, torch.where(wh_ok, scores, 0.0)

    def postprocess(self, logits_l, deltas_l, moment_transfer, image_hw, scale, orig_size):
        boxes, scores = self.candidates(logits_l, deltas_l, moment_transfer, image_hw)
        return proposal_outputs(boxes, scores, self.nms_thresh, self.max_dets, scale,
                                orig_size)
