"""ProposalNetworkWithMasks (counterpart of
``slenderobjdet_tpu/models/meta_arch/proposal_network.py``:
``PointsProposalHead`` and ``ProposalNetworkWithMasks``).

- Head: two 3x3 conv + ``GroupNorm32`` + relu tower layers, then a 3x3
  objectness conv (bias at the 0.01 prior) and a 3x3 regression conv
  decoded as ``exp(clip(., -12, 9))`` ltrb distances.
- Targets: ``fcos_assign`` with one class; the objectness target is
  ``batch["center_mask"]`` (B, H, W) at each location when given, else the
  in-box mask.
- Loss: the objectness BCE's mean plus the IoU loss of the positives over
  their (global) count.
- Predict: a level's top 1000 scores, their ltrb boxes, class-agnostic NMS
  at ``MODEL.RPN.NMS_THRESH``, rescaled and clipped; class 0, also under the
  proposal keys. ``TPU.INT8_PREDICT`` runs the network of ``predict`` under
  ``ops.quant.int8_predict_scope``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import iou_loss_ltrb, optax_sigmoid_ce
from ...ops.quant import int8_predict_scope
from ...ops.topk import top_k_by_index
from ...parallel.multihost import global_normalizer
from ...structures import boxes as box_ops
from ..anchors import fcos_locations
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, GroupNorm32, init_detector_weights, prior_bias,
                      uses_batch_statistics)
from ..proposal_generator.rpg import proposal_outputs
from .fcos import fcos_assign, sizes_of_interest
from .reppoints import RepPointsModule

__all__ = ["PointsProposalHead", "ProposalNetworkWithMasks"]


class PointsProposalHead(nn.Module):
    """``forward(feats)`` -> per-level (B, H*W) logits and (B, H*W, 4) ltrb
    distances, float32, row-major (h, w)."""

    def __init__(self, in_channels: int, num_convs: int = 2):
        super().__init__()
        c = in_channels
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"tower{i}", Conv2d(c, c, 3, padding=1))
            self.add_module(f"gn{i}", GroupNorm32(c))
        self.objectness = Conv2d(c, 1, 3, padding=1)
        self.deltas = Conv2d(c, 4, 3, padding=1)

    def forward(self, feats: List[torch.Tensor]):
        logits, regs = [], []
        for f in feats:
            b, _, h, w = f.shape
            t = f
            for i in range(self.num_convs):
                t = F.relu(getattr(self, f"gn{i}")(getattr(self, f"tower{i}")(t)))
            logits.append(self.objectness(t).float().reshape(b, h * w))
            reg = torch.exp(torch.clamp(self.deltas(t).float(), -12.0, 9.0))
            regs.append(reg.permute(0, 2, 3, 1).reshape(b, h * w, 4))
        return logits, regs


class ProposalNetworkWithMasks(RepPointsModule):
    """Proposal-only detector over the points proposal head."""

    def __init__(self, cfg):
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        pg = cfg.MODEL.PROPOSAL_GENERATOR
        in_features = (list(cfg.MODEL.FCOS.IN_FEATURES) if list(pg.IN_FEATURES) == ["p5"]
                       else list(pg.IN_FEATURES))
        backbone = build_backbone(cfg)
        super().__init__(backbone, PointsProposalHead(cfg.MODEL.FPN.OUT_CHANNELS),
                         in_features, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.nms_thresh = cfg.MODEL.RPN.NMS_THRESH
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.strides = [backbone.strides[f] for f in self.in_features]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights``; the objectness bias at the 0.01 prior."""
        init_detector_weights(self, generator)
        self.head.objectness.bias.fill_(prior_bias(0.01))

    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image", "gt_boxes", "gt_classes", "gt_valid"} and
        optionally "center_mask" (B, H, W). Returns the total loss and
        {"loss_objectness", "loss_reg", "num_pos"}."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        locations_np, counts = fcos_locations(tuple(images.shape[1:3]), self.strides)
        locations = torch.as_tensor(locations_np, device=dev)
        soi = torch.as_tensor(sizes_of_interest(counts), device=dev)
        logits_l, regs_l = self(images)
        logits = torch.cat(logits_l, dim=1)
        regs = torch.cat(regs_l, dim=1)

        gt_classes = torch.as_tensor(batch["gt_classes"], device=dev)
        labels, reg_targets, _ = fcos_assign(
            locations, soi, torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
            torch.zeros_like(gt_classes),
            torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev), 1)
        pos = labels < 1
        if "center_mask" in batch:
            cm = torch.as_tensor(batch["center_mask"], dtype=torch.float32, device=dev)
            ix = torch.clamp(locations[:, 0].int(), 0, cm.shape[2] - 1).long()
            iy = torch.clamp(locations[:, 1].int(), 0, cm.shape[1] - 1).long()
            obj_target = cm[:, iy, ix]
        else:
            obj_target = pos.float()

        num_pos, pos_share = global_normalizer(pos.sum().float(), 1.0)
        # the mean over the global batch: every process holds as many rows
        obj_loss = optax_sigmoid_ce(logits, obj_target).mean()
        safe = torch.where(pos[..., None], reg_targets, 1.0)
        reg_loss = torch.where(pos, iou_loss_ltrb(regs, safe, "iou"), 0.0).sum() / pos_share
        return obj_loss + reg_loss, {"loss_objectness": obj_loss, "loss_reg": reg_loss,
                                     "num_pos": num_pos}

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """As ``RepPointsGenerator.predict``."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            logits_l, regs_l = self(images)
        return self.postprocess(logits_l, regs_l, tuple(images.shape[1:3]),
                                torch.as_tensor(batch["scale"], device=dev),
                                torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, regs_l, image_hw):
        """Per level the top 1000 ltrb boxes by sigmoid score, concatenated."""
        locations_np, counts = fcos_locations(image_hw, self.strides)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cb, cs = [], []
        for lvl, (logits, regs) in enumerate(zip(logits_l, regs_l)):
            locs = torch.as_tensor(locations_np[offsets[lvl]: offsets[lvl + 1]],
                                   device=logits.device)
            top, idx = top_k_by_index(torch.sigmoid(logits), min(1000, logits.shape[1]))
            sel = torch.gather(regs, 1, idx[..., None].expand(-1, -1, 4))
            cb.append(box_ops.decode_ltrb(locs[idx], sel))
            cs.append(top)
        return torch.cat(cb, dim=1), torch.cat(cs, dim=1)

    def postprocess(self, logits_l, regs_l, image_hw, scale, orig_size):
        boxes, scores = self.candidates(logits_l, regs_l, image_hw)
        return proposal_outputs(boxes, scores, self.nms_thresh, self.max_dets, scale,
                                orig_size)
