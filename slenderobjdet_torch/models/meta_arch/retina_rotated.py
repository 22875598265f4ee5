"""Rotated RetinaNet over XYWHA boxes (counterpart of
``slenderobjdet_tpu/models/meta_arch/retina_rotated.py``:
``rotated_label_anchors``, ``RotatedHead`` and ``RotatedRetinaNet``; the
reference's RetinaNet head regressing Box2BoxTransformRotated deltas over
rotated anchors, registered as "RotatedRetinaNet").

Anchors are SIZES x ASPECT_RATIOS x ANGLES a cell
(``anchors.RotatedAnchorGeneratorSpec``). Each image's anchors are labelled
by the IoU matcher with low-quality matches over the exact rotated IoU
(``ops/rotated.py:pairwise_rotated_iou``: on CUDA tensors one launch of the
IoU kernel an image); the losses are RetinaNet's, over the global batch's
foreground count, with the regression targets the rotated deltas.
Inference is per-level top-k of the sigmoid scores, the score threshold as a
mask, the rotated deltas decoded, and class-aware rotated NMS through the
centre offset ``class * 4096`` (``ops/rotated.py:rotated_nms``: on CUDA
tensors one launch of the NMS kernel a call). Output boxes are XYWHA in the
original image: cx, cy, w, h divided by the scale, the angle unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.quant import int8_predict_scope
from ...ops.rotated import (apply_rotated_deltas, get_rotated_deltas, offset_boxes,
                            pairwise_rotated_iou, rotated_nms)
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_normalizer
from ..anchors import RotatedAnchorGeneratorSpec
from ..backbones.fpn import build_backbone
from ..layers import init_detector_weights, prior_bias, uses_batch_statistics
from .retinanet import RetinaNetHead, RetinaNetModule, retinanet_label_anchors


def rotated_label_anchors(anchors, gt_rboxes, gt_classes, gt_valid, thresholds, labels,
                          num_classes):
    """One image's anchor labels by the IoU matcher with low-quality matches
    over the rotated IoU: (labels (N,) int64 in [0, C-1] foreground, C
    background, -1 ignored; matched gt rboxes (N, 5))."""
    return retinanet_label_anchors(anchors, gt_rboxes, gt_classes, gt_valid, thresholds,
                                   labels, num_classes, pairwise_fn=pairwise_rotated_iou)


class RotatedHead(RetinaNetHead):
    """RetinaNet's head regressing 5 deltas (XYWHA) an anchor."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int = 4, prior_prob: float = 0.01):
        super().__init__(in_channels, num_classes, num_anchors, num_convs, prior_prob,
                         box_dim=5)


class RotatedRetinaNet(RetinaNetModule):
    """Config-driven rotated RetinaNet. ``loss`` reads ``gt_rboxes`` (B, G,
    5); ``predict`` returns XYWHA detections."""

    def __init__(self, cfg):
        r = cfg.MODEL.RETINANET
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        in_features = list(r.IN_FEATURES)
        strides = [backbone.strides[f] for f in in_features]
        anchor_spec = RotatedAnchorGeneratorSpec(cfg, strides)
        head = RotatedHead(cfg.MODEL.FPN.OUT_CHANNELS, r.NUM_CLASSES,
                           anchor_spec.num_cell_anchors[0], r.NUM_CONVS, r.PRIOR_PROB)
        super().__init__(backbone, head, in_features, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.anchor_spec = anchor_spec
        self.num_classes = r.NUM_CLASSES
        self.focal_alpha = r.FOCAL_LOSS_ALPHA
        self.focal_gamma = r.FOCAL_LOSS_GAMMA
        self.smooth_l1_beta = r.SMOOTH_L1_LOSS_BETA
        self.iou_thresholds = list(r.IOU_THRESHOLDS)
        self.iou_labels = list(r.IOU_LABELS)
        self.score_thresh = r.SCORE_THRESH_TEST
        self.topk_candidates = r.TOPK_CANDIDATES_TEST
        self.nms_thresh = r.NMS_THRESH_TEST
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        w = tuple(r.BBOX_REG_WEIGHTS)
        self.box_reg_weights = w + (1.0,) * (5 - len(w))
        self._anchor_cache = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` and the cls bias at the focal prior."""
        init_detector_weights(self, generator)
        self.head.cls_score.bias.fill_(prior_bias(self.head.prior_prob))

    def anchors(self, image_hw) -> Tuple[torch.Tensor, list]:
        """The anchors (N, 5) on the model's device and the per-level counts
        for a padded image shape (kept for the shapes seen, except while
        ``torch.export`` traces, whose tensors must not outlive the trace)."""
        dev = self.pixel_mean.device
        key = (tuple(int(v) for v in image_hw), str(dev))
        if key in self._anchor_cache:
            return self._anchor_cache[key]
        anchors, counts = self.anchor_spec.anchors(key[0])
        entry = (torch.as_tensor(anchors, device=dev), counts)
        if not torch.compiler.is_compiling():
            self._anchor_cache[key] = entry
        return entry

    @torch.no_grad()
    def label_batch(self, anchors, gt_rboxes, gt_classes, gt_valid):
        """Labels (B, N) and matched gt rboxes (B, N, 5), image by image."""
        per_image = [rotated_label_anchors(
            anchors, gt_rboxes[b], gt_classes[b], gt_valid[b], self.iou_thresholds,
            self.iou_labels, self.num_classes) for b in range(gt_rboxes.shape[0])]
        labels, matched = zip(*per_image)
        return torch.stack(labels), torch.stack(matched)

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_rboxes": (B, G, 5) XYWHA,
        "gt_classes": (B, G), "gt_valid": (B, G)} as numpy arrays or tensors.
        Returns the total and {"loss_cls", "loss_box_reg", "num_pos"}."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        anchors, _ = self.anchors(images.shape[1:3])
        logits_l, regs_l = self(images)
        logits = torch.cat(logits_l, dim=1)
        regs = torch.cat(regs_l, dim=1)
        gt_labels, matched = self.label_batch(
            anchors, torch.as_tensor(batch["gt_rboxes"], dtype=torch.float32, device=dev),
            torch.as_tensor(batch["gt_classes"], device=dev),
            torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev))

        valid = gt_labels >= 0
        fg = valid & (gt_labels < self.num_classes)
        num_fg, fg_share = global_normalizer(fg.sum().float(), 1.0)

        classes = torch.arange(self.num_classes, device=dev)
        onehot = (gt_labels[..., None] == classes).float()
        cls_all = sigmoid_focal_loss(logits, onehot, self.focal_alpha, self.focal_gamma)
        cls_loss = torch.where(valid[..., None], cls_all, 0.0).sum() / fg_share

        # rows that are not foreground get a safe target before the loss
        off = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
        safe = torch.where(fg[..., None], matched, anchors[None] + off)
        target = get_rotated_deltas(anchors[None].expand_as(safe), safe,
                                    weights=self.box_reg_weights)
        reg_all = smooth_l1_loss(regs, target, self.smooth_l1_beta)
        reg_loss = torch.where(fg[..., None], reg_all, 0.0).sum() / fg_share
        return cls_loss + reg_loss, {"loss_cls": cls_loss, "loss_box_reg": reg_loss,
                                     "num_pos": num_fg}

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,), "orig_size":
        (B, 2)}. Returns boxes (B, D, 5) XYWHA in original image coordinates,
        scores (B, D), classes (B, D) int32 and valid (B, D) bool."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            logits_l, regs_l = self(images)
        boxes, scores, classes, valid = self.candidates(logits_l, regs_l,
                                                        tuple(images.shape[1:3]))
        keep_idx, keep_valid = rotated_nms(offset_boxes(boxes, classes), scores,
                                           self.nms_thresh, self.max_dets, valid=valid)
        keep = keep_idx.long()
        kept = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 5))
        scale = torch.as_tensor(batch["scale"], device=dev).float()[:, None, None]
        return {"boxes": torch.cat([kept[..., :4] / scale, kept[..., 4:]], dim=-1),
                "scores": torch.gather(scores, 1, keep),
                "classes": torch.gather(classes, 1, keep),
                "valid": keep_valid}

    def candidates(self, logits_l, regs_l, image_hw):
        """The NMS's input: each level's top-k (anchor, class) pairs by
        sigmoid score, decoded: boxes (B, K, 5), scores (B, K), classes (B,
        K) int32 and the score-threshold mask (B, K), K the levels' k
        summed."""
        anchors, counts = self.anchors(image_hw)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cb, cs, cc, cv = [], [], [], []
        for lvl in range(len(counts)):
            lvl_anchors = anchors[int(offsets[lvl]):int(offsets[lvl + 1])]
            scores = torch.sigmoid(logits_l[lvl].float())
            top_scores, a_idx, cls_idx = pair_top_k(scores, self.topk_candidates)
            sel = torch.gather(regs_l[lvl], 1, a_idx[..., None].expand(-1, -1, 5))
            cb.append(apply_rotated_deltas(sel, lvl_anchors[a_idx],
                                           weights=self.box_reg_weights))
            cs.append(top_scores)
            cc.append(cls_idx)
            cv.append(top_scores > self.score_thresh)
        return (torch.cat(cb, 1), torch.cat(cs, 1), torch.cat(cc, 1), torch.cat(cv, 1))
