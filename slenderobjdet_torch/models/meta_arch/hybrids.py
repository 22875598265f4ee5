"""Variant meta-architectures (counterpart of
``slenderobjdet_tpu/models/meta_arch/hybrids.py``). Each reuses the core
machinery:
- ``FCOSRetinaNet`` and ``FCOSNCRetinaNet``: FCOS heads (ltrb at locations)
  with and without the centerness branch, the centerness ablation pair;
- ``PointRetinaNet``: RetinaNet with the nearest-point assignment;
- ``RepPointsCenterness``: RepPoints with a centerness branch, a 1x1
  ``ctn_out`` on the FPN feature, whose target is the refine-matched gt's
  centerness (``MODEL.META_ARCH.SLENDER_CENTERNESS``: the slender one) and
  whose log-sigmoid gates the logits at inference;
- ``ReppointsRetinaNet``: the point-set head under the RetinaNet keys, with
  ``NUM_POINTS`` from ``MODEL.PROPOSAL_GENERATOR``, 256 channels, 3 stacked
  convs, gradient_mul 0.1 and ``minmax`` hard-wired;
- ``FCOSRepPoints``: RepPoints whose init stage takes the 3 nearest points a
  gt;
- ``RepPointsV2``: the full-stride offset decode, MaxIoU .5/.4 refine
  assignment with gt-max augmentation on init boxes clamped at 0, losses
  over batch totals weighted by ``MODEL.REPPOINTS.LOSS_*_WEIGHT``, no EMA
  normaliser, and the ``MODEL.REPPOINTS.*_TEST`` keys.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...ops.losses import optax_sigmoid_ce, sigmoid_focal_loss
from ...parallel.multihost import global_normalizer, global_sum, process_share
from ...structures import boxes as box_ops
from ..layers import Conv2d, uses_batch_statistics
from ..matchers import iou_matcher
from .ablation import compute_slender_centerness_targets  # noqa: F401
from .fcos import FCOS, compute_centerness_targets
from .reppoints import RepPointsDetector, RepPointsHead
from .retinanet import RetinaNet


class FCOSRetinaNet(FCOS):
    """FCOS head with the centerness branch: focal loss over num_pos, IoU
    loss weighted by the centerness targets over their sum, centerness BCE
    over num_pos, inference ranked by sqrt(cls * ctr)."""

    def __init__(self, cfg):
        super().__init__(cfg, use_centerness=True)


class FCOSNCRetinaNet(FCOS):
    """The no-centerness partner: a head without the centerness conv, the
    regression loss over num_pos, inference ranked by the raw class score."""

    def __init__(self, cfg):
        super().__init__(cfg, use_centerness=False)


class PointRetinaNet(RetinaNet):
    """RetinaNet with point-based (nearest at the gt's level) assignment."""

    def __init__(self, cfg):
        super().__init__(cfg, assign_mode="nearest")


# ------------------------------------------------------- RepPoints + centerness
class RepPointsCenternessHead(RepPointsHead):
    """``RepPointsHead`` plus a 1x1 ``ctn_out`` on each level's FPN feature:
    a fourth list of (B, H*W) float32 centerness logits."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels, *args, **kwargs)
        self.ctn_out = Conv2d(in_channels, 1, 1)

    def forward(self, feats):
        logits_l, init_l, refine_l = super().forward(feats)
        ctr_l = [self.ctn_out(x).float().reshape(x.shape[0], -1) for x in feats]
        return logits_l, init_l, refine_l, ctr_l


class RepPointsCenterness(RepPointsDetector):
    """RepPoints with the centerness branch: its BCE over the refine stage's
    IoU-matched points (targets from their gt's ltrb at the point centres)
    joins the loss as ``centerness_loss``; ``predict`` adds
    ``log_sigmoid(ctr)`` to the logits before ranking."""

    head_class = RepPointsCenternessHead

    def __init__(self, cfg):
        super().__init__(cfg)
        self.slender_centerness = cfg.MODEL.META_ARCH.SLENDER_CENTERNESS

    @uses_batch_statistics
    def loss(self, batch):
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        image_hw = tuple(images.shape[1:3])
        logits_l, init_l, refine_l, ctr_l = self(images)
        t = self._targets_input(batch, image_hw, logits_l, init_l, refine_l)
        total, metrics = self._losses(t)
        fg, ltrb = self._centerness_targets(t)
        ctr = torch.cat(ctr_l, dim=1)
        safe = torch.where(fg[..., None], ltrb, 1.0)
        ctr_fn = (compute_slender_centerness_targets if self.slender_centerness
                  else compute_centerness_targets)
        tgt = torch.where(fg, ctr_fn(safe), 0.0)
        _, pos_share = global_normalizer(fg.sum().float(), 1.0)
        ctr_loss = torch.where(fg, optax_sigmoid_ce(ctr, tgt), 0.0).sum() / pos_share
        metrics = dict(metrics, centerness_loss=ctr_loss)
        return total + ctr_loss, metrics

    @torch.no_grad()
    def _centerness_targets(self, t):
        """The refine boxes' foreground (IoU matcher label 1) (B, L) and
        their matched gt's ltrb at the point centres (B, L, 4)."""
        fg, ltrb = [], []
        c = t["centers"]
        for b in range(t["gt_boxes"].shape[0]):
            midx, mlab = iou_matcher(t["refine_boxes"][b].detach(), t["gt_boxes"][b],
                                     t["gt_valid"][b], self.iou_thresholds,
                                     self.iou_labels, allow_low_quality_matches=True)
            m = t["gt_boxes"][b][midx.long()]
            ltrb.append(torch.stack([c[:, 0] - m[:, 0], c[:, 1] - m[:, 1],
                                     m[:, 2] - c[:, 0], m[:, 3] - c[:, 1]], dim=-1))
            fg.append(mlab == 1)
        return torch.stack(fg), torch.stack(ltrb)

    def score_logits(self, outputs):
        return [lg + F.logsigmoid(ct)[..., None] for lg, ct in zip(outputs[0], outputs[3])]


# ------------------------------------------------------ RetinaNet-head RepPoints
class ReppointsRetinaNet(RepPointsDetector):
    """The point-set detector under the RetinaNet keys: ``NUM_POINTS`` from
    ``MODEL.PROPOSAL_GENERATOR``, a head of 256 channels, 3 stacked convs,
    gradient_mul 0.1 and prior 0.01 whatever ``MODEL.REPPOINTS`` says, and
    ``minmax`` boxes."""

    @classmethod
    def settings(cls, cfg) -> Dict:
        return dict(super().settings(cfg), num_points=cfg.MODEL.PROPOSAL_GENERATOR.NUM_POINTS,
                    transform_method="minmax", feat_channels=256, stack_convs=3,
                    gradient_mul=0.1, prior_prob=0.01)


# ------------------------------------------------------ FCOS-RepPoints hybrid
class FCOSRepPoints(RepPointsDetector):
    """RepPoints whose init stage takes the 3 nearest points a gt (ties to
    the lowest index, as ``jax.lax.top_k`` takes them)."""

    init_pos_num = 3


# ------------------------------------------------------------- RepPoints V2
class RepPointsV2(RepPointsDetector):
    """The reference's RepPointsV2 (a plain RepPoints head, no verification
    branch): offsets decoded at the full stride, init targets by the nearest
    point, refine targets by MaxIoU (>= 0.5 foreground, else background, no
    ignore band) plus every candidate tying a gt's best IoU, on init boxes
    clamped at 0; the losses over the batch's totals, weighted by
    ``LOSS_CLS_WEIGHT``, ``LOSS_BBOX_INIT_WEIGHT`` and
    ``LOSS_BBOX_REFINE_WEIGHT``; no EMA normaliser."""

    uses_loss_normalizer = False

    @classmethod
    def settings(cls, cfg) -> Dict:
        rp = cfg.MODEL.REPPOINTS
        return dict(super().settings(cfg), num_classes=rp.NUM_CLASSES,
                    in_features=list(rp.IN_FEATURES), focal_alpha=rp.FOCAL_LOSS_ALPHA,
                    focal_gamma=rp.FOCAL_LOSS_GAMMA, score_thresh=rp.SCORE_THRESH_TEST,
                    topk_candidates=rp.TOPK_CANDIDATES_TEST,
                    nms_thresh=rp.NMS_THRESH_TEST, feat_channels=rp.FEAT_CHANNELS,
                    full_stride_points=True)

    def __init__(self, cfg):
        super().__init__(cfg)
        rp = cfg.MODEL.REPPOINTS
        self.loss_cls_weight = rp.LOSS_CLS_WEIGHT
        self.loss_init_weight = rp.LOSS_BBOX_INIT_WEIGHT
        self.loss_refine_weight = rp.LOSS_BBOX_REFINE_WEIGHT

    @torch.no_grad()
    def _refine_targets(self, t):
        labels, boxes = [], []
        for b in range(t["gt_boxes"].shape[0]):
            gt_b, gt_c, gt_v = t["gt_boxes"][b], t["gt_classes"][b], t["gt_valid"][b]
            cand = torch.clamp(t["init_boxes"][b].detach(), min=0.0)
            ious = box_ops.pairwise_iou(cand, gt_b)                 # (L, G)
            ious = torch.where(gt_v[None, :], ious, -1.0)
            max_iou, arg = ious.amax(dim=1), torch.argmax(ious, dim=1)
            lab = torch.where(max_iou >= 0.5, gt_c[arg], self.num_classes)
            # gt-max augmentation: any candidate tying a gt's best IoU
            gt_max = ious.amax(dim=0)
            tie = (ious == gt_max[None, :]) & (gt_max[None, :] > 0) & gt_v[None, :]
            labels.append(torch.where(tie.any(dim=1), gt_c[arg], lab))
            boxes.append(gt_b[arg])
        return torch.stack(labels), torch.stack(boxes)

    def _losses(self, t):
        init_obj, init_gt_boxes = self._init_targets(t)
        gt_cls, refine_gt_boxes = self._refine_targets(t)
        fg = gt_cls < self.num_classes
        # the global batch's counts, one all-reduce for both
        num_fg, num_init = global_sum(torch.stack([fg.sum(), init_obj.sum()]))
        refine_share = process_share(torch.clamp(num_fg.float(), min=1.0))
        init_share = process_share(torch.clamp(num_init.float(), min=1.0))

        cls_all = sigmoid_focal_loss(t["logits"], self._onehot(gt_cls),
                                     self.focal_alpha, self.focal_gamma)
        loss_cls = cls_all.sum() / refine_share * self.loss_cls_weight
        loss_init = (self._box_loss(t, t["init_boxes"], init_gt_boxes, init_obj)
                     / init_share * self.loss_init_weight)
        loss_refine = (self._box_loss(t, t["refine_boxes"], refine_gt_boxes, fg)
                       / refine_share * self.loss_refine_weight)
        total = loss_cls + loss_init + loss_refine
        return total, {"loss_cls": loss_cls, "loss_pts_init": loss_init,
                       "loss_pts_refine": loss_refine, "num_pos": num_fg}
