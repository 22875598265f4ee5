"""RetinaNet (counterpart of
``slenderobjdet_tpu/models/meta_arch/retinanet.py``: ``RetinaNetHead``,
``RetinaNetModule``, ``retinanet_label_anchors``, ``RetinaNet`` with its three
assignment modes, ``_retina_level_candidates`` and the subclasses).

Anchors come from cfg.MODEL.ANCHOR_GENERATOR per padded image shape, on the
host. Training is fixed-shape: padded gt with a validity mask, each anchor
labelled by the IoU matcher with low-quality matches (or by FCOS's
assignment or the nearest-point assignment at the anchor centres), sigmoid
focal loss over the anchors that are not ignored and smooth-L1 on the
foreground anchors' deltas, both over the batch's foreground count. The
labels need no gradient and are made image by image under
``torch.no_grad()``, so that one image's (G, N) IoU planes are all that lives
at once. Inference is per-level top-k of the sigmoid scores, then the score
threshold, delta decoding and class-aware greedy NMS; on CUDA tensors the NMS
always runs the hand-written kernel (``ops/nms.py:cuda_batched_nms``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.nms import cuda_batched_nms
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_normalizer
from ...structures import boxes as box_ops
from ..anchors import AnchorGeneratorSpec
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, DFConv2d, init_detector_weights, prior_bias,
                      uses_batch_statistics)
from ..matchers import iou_matcher
from .fcos import fcos_assign, sizes_of_interest
from .reppoints import rep_points_assign_with_idx


class RetinaNetHead(nn.Module):
    """Shared 4-conv cls/bbox subnets without norms, ``num_anchors`` anchors a
    cell, ``box_dim`` deltas an anchor; ``use_dcn`` makes each subnet conv a
    modulated ``DFConv2d`` (DeformableConvRetinaNet)."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 use_dcn: bool = False, box_dim: int = 4):
        super().__init__()
        c = in_channels
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.box_dim = box_dim
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        for prefix in ("cls", "bbox"):
            for i in range(num_convs):
                self.add_module(f"{prefix}_subnet{i}",
                                DFConv2d(c, c, modulated=True) if use_dcn
                                else Conv2d(c, c, 3, padding=1))
        self.cls_score = Conv2d(c, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(c, num_anchors * box_dim, 3, padding=1)

    def _subnet(self, prefix, x):
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"{prefix}_subnet{i}")(x))
        return x

    def forward(self, feats: List[torch.Tensor]):
        """feats: list of (B, C, H_l, W_l). Returns per-level lists of
        (B, H*W*A, num_classes) logits and (B, H*W*A, box_dim) deltas, float32,
        rows cell by cell in row-major (h, w) order and anchor-minor within a
        cell, which is the order of ``anchors_per_level``."""
        logits, regs = [], []
        for x in feats:
            b, _, h, w = x.shape
            n = h * w * self.num_anchors
            lg = self.cls_score(self._subnet("cls", x)).float()
            rg = self.bbox_pred(self._subnet("bbox", x)).float()
            # NCHW -> (b, h, w, A*C) before the reshape
            logits.append(lg.permute(0, 2, 3, 1).reshape(b, n, self.num_classes))
            regs.append(rg.permute(0, 2, 3, 1).reshape(b, n, self.box_dim))
        return logits, regs


class RetinaNetModule(nn.Module):
    """Backbone + FPN + RetinaNet head over uint8 NHWC images; the image is
    normalised in float32 and then cast to the compute dtype."""

    def __init__(self, backbone: nn.Module, head: RetinaNetHead,
                 in_features: Sequence[str], pixel_mean: Sequence[float],
                 pixel_std: Sequence[float], dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.in_features = tuple(in_features)
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)

    def forward(self, images: torch.Tensor):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        # NHWC -> NCHW view, which is channels_last memory
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = self.backbone(x)
        return self.head([feats[f] for f in self.in_features])


def retinanet_label_anchors(anchors, gt_boxes, gt_classes, gt_valid,
                            thresholds, labels, num_classes, pairwise_fn=None):
    """One image's anchor labels by the IoU matcher with low-quality matches:
    (gt_labels (N,) int64, matched_boxes (N, 4)) with gt_labels in
    [0, C-1] foreground, C background, -1 ignored. ``pairwise_fn`` replaces
    the box IoU (the rotated detector's)."""
    matched_idx, match_labels = iou_matcher(
        anchors, gt_boxes, gt_valid, thresholds, labels,
        allow_low_quality_matches=True, pairwise_fn=pairwise_fn)
    matched_idx = matched_idx.long()
    out = torch.where(match_labels == 1, gt_classes.long()[matched_idx],
                      num_classes)
    out = torch.where(match_labels == -1, -1, out)
    return out, gt_boxes[matched_idx]


def _retina_level_candidates(logits, regs, anchors, score_thresh, topk,
                             weights):
    """One level's candidates in fixed shape: top-k over the flattened
    (anchor, class) sigmoid scores, THEN the score threshold as a mask.

    logits (B, N, C); regs (B, N, 4); anchors (N, 4). Returns boxes
    (B, K, 4), scores (B, K), classes (B, K) int32, valid (B, K) bool and the
    candidates' anchors (B, K, 4), with K = min(topk, N*C)."""
    scores = torch.sigmoid(logits.float())                        # (B, N, C)
    top_scores, anchor_idx, cls_idx = pair_top_k(scores, topk)
    valid = top_scores > score_thresh

    sel_regs = torch.gather(regs, 1, anchor_idx[..., None].expand(-1, -1, 4))
    sel_anchors = anchors[anchor_idx]
    boxes = box_ops.apply_deltas(sel_regs, sel_anchors, weights=weights)
    return boxes, top_scores, cls_idx, valid, sel_anchors


class RetinaNet(RetinaNetModule):
    """Config-driven RetinaNet detector (the interface of ``FCOS``).

    ``assign_mode`` selects how anchors are labelled:
    - "iou": the IoU matcher (RetinaNet);
    - "fcos": FCOS's in-box and size-of-interest assignment at the anchor
      centres (CenternessRetinaNet);
    - "nearest": the nearest point at the gt's pyramid level
      (NearestRetinaNet, PointRetinaNet).
    ``with_anchor`` makes ``predict`` return each detection's anchor."""

    def __init__(self, cfg, use_dcn: bool = False, assign_mode: str = "iou",
                 with_anchor: bool = False):
        if assign_mode not in ("iou", "fcos", "nearest"):
            raise ValueError(assign_mode)
        if cfg.TPU.PACK_HEAD_LEVELS:
            raise NotImplementedError("TPU.PACK_HEAD_LEVELS is not ported")
        r = cfg.MODEL.RETINANET
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        in_features = list(r.IN_FEATURES)
        strides = [backbone.strides[f] for f in in_features]
        anchor_spec = AnchorGeneratorSpec(cfg, strides)
        num_anchors = anchor_spec.num_cell_anchors[0]
        assert all(a == num_anchors for a in anchor_spec.num_cell_anchors)
        head = RetinaNetHead(
            in_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            num_classes=r.NUM_CLASSES,
            num_anchors=num_anchors,
            num_convs=r.NUM_CONVS,
            prior_prob=r.PRIOR_PROB,
            use_dcn=use_dcn,
        )
        super().__init__(backbone, head, in_features, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.assign_mode = assign_mode
        self.with_anchor = with_anchor
        self.strides = strides
        self.anchor_spec = anchor_spec
        self.num_classes = r.NUM_CLASSES
        self.focal_alpha = r.FOCAL_LOSS_ALPHA
        self.focal_gamma = r.FOCAL_LOSS_GAMMA
        self.smooth_l1_beta = r.SMOOTH_L1_LOSS_BETA
        self.box_reg_weights = tuple(r.BBOX_REG_WEIGHTS)
        self.iou_thresholds = list(r.IOU_THRESHOLDS)
        self.iou_labels = list(r.IOU_LABELS)
        self.score_thresh = r.SCORE_THRESH_TEST
        self.topk_candidates = r.TOPK_CANDIDATES_TEST
        self.nms_thresh = r.NMS_THRESH_TEST
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` and the cls bias at the focal prior."""
        init_detector_weights(self, generator)
        self.head.cls_score.bias.fill_(prior_bias(self.head.prior_prob))

    def _anchors(self, image_hw) -> Tuple[np.ndarray, List[int]]:
        return self.anchor_spec.anchors(tuple(image_hw))

    # --------------------------------------------------------- assignment
    @torch.no_grad()
    def _label_batch(self, anchors_np, counts, gt_boxes, gt_classes, gt_valid):
        """Labels (B, N) int64 ([0, C-1] foreground, C background, -1
        ignored) and matched gt boxes (B, N, 4) for gt_boxes (B, G, 4),
        gt_classes (B, G) and gt_valid (B, G) on the model's device, one image
        at a time."""
        dev = gt_boxes.device
        images = range(gt_boxes.shape[0])
        if self.assign_mode == "iou":
            anchors = torch.as_tensor(anchors_np, device=dev)
            per_image = [retinanet_label_anchors(
                anchors, gt_boxes[b], gt_classes[b], gt_valid[b],
                self.iou_thresholds, self.iou_labels, self.num_classes)
                for b in images]
        else:
            # anchor centres, floor-divided on the host as float32
            centers = torch.as_tensor(np.stack(
                [(anchors_np[:, 0] + anchors_np[:, 2]) // 2,
                 (anchors_np[:, 1] + anchors_np[:, 3]) // 2],
                axis=1).astype(np.float32), device=dev)
            if self.assign_mode == "fcos":
                soi = torch.as_tensor(sizes_of_interest(counts), device=dev)

                def one(b):
                    labels, reg, _ = fcos_assign(
                        centers, soi, gt_boxes[b:b + 1], gt_classes[b:b + 1],
                        gt_valid[b:b + 1], self.num_classes)
                    return labels[0], box_ops.decode_ltrb(centers, reg[0])
            else:
                lvls = torch.as_tensor(np.concatenate([
                    np.full(c, int(np.log2(s)), np.int32)
                    for c, s in zip(counts, self.strides)]), device=dev)
                lvl_min = int(np.log2(self.strides[0]))
                lvl_max = int(np.log2(self.strides[-1]))

                def one(b):
                    obj, idx = rep_points_assign_with_idx(
                        centers, lvls, gt_boxes[b], gt_valid[b], lvl_min, lvl_max)
                    labels = torch.where(obj, gt_classes[b].long()[idx],
                                         self.num_classes)
                    return labels, gt_boxes[b][idx]
            per_image = [one(b) for b in images]
        labels, matched = zip(*per_image)
        return torch.stack(labels), torch.stack(matched)

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4) XYXY,
        "gt_classes": (B, G) int, "gt_valid": (B, G) bool} as numpy arrays
        or tensors. Returns the total loss and {"loss_cls", "loss_box_reg",
        "num_pos"}; both losses are over the global batch's foreground
        count."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        anchors_np, counts = self._anchors(images.shape[1:3])
        anchors = torch.as_tensor(anchors_np, device=dev)

        logits_l, regs_l = self(images)
        logits = torch.cat(logits_l, dim=1)          # (B, N, C)
        regs = torch.cat(regs_l, dim=1)              # (B, N, 4)

        gt_labels, matched_boxes = self._label_batch(
            anchors_np, counts,
            torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
            torch.as_tensor(batch["gt_classes"], device=dev),
            torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev))

        valid = gt_labels >= 0                       # not ignored
        fg = valid & (gt_labels < self.num_classes)
        num_fg, fg_share = global_normalizer(fg.sum().float(), 1.0)

        # ignored (-1) and background (C) rows of the one-hot are zero
        classes = torch.arange(self.num_classes, device=dev)
        onehot = (gt_labels[..., None] == classes).float()
        cls_all = sigmoid_focal_loss(logits, onehot, self.focal_alpha,
                                     self.focal_gamma)
        cls_loss = torch.where(valid[..., None], cls_all, 0.0).sum() / fg_share

        # smooth-L1 on the anchor deltas. Rows that are not foreground get a
        # safe target BEFORE the loss: a where after it does not stop a NaN
        # gradient from the untaken branch.
        safe_boxes = torch.where(fg[..., None], matched_boxes,
                                 anchors[None] + 1.0)
        target_deltas = box_ops.get_deltas(
            anchors[None].expand_as(safe_boxes), safe_boxes,
            weights=self.box_reg_weights)
        reg_all = smooth_l1_loss(regs, target_deltas, self.smooth_l1_beta)
        reg_loss = torch.where(fg[..., None], reg_all, 0.0).sum() / fg_share

        return cls_loss + reg_loss, {"loss_cls": cls_loss,
                                     "loss_box_reg": reg_loss,
                                     "num_pos": num_fg}

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,),
        "orig_size": (B, 2)} as numpy arrays or tensors. Returns fixed-shape
        detections in original image coordinates: boxes (B, D, 4), scores
        (B, D), classes (B, D) int32, valid (B, D) bool and, ``with_anchor``,
        each detection's anchor (B, D, 4), rescaled and clipped like its
        box."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            logits_l, regs_l = self(images)
        return self.postprocess(
            logits_l, regs_l, tuple(images.shape[1:3]),
            torch.as_tensor(batch["scale"], device=dev),
            torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, regs_l, image_hw):
        """The NMS's input from the head's per-level outputs: boxes
        (B, N, 4), scores (B, N), classes (B, N) int32, valid (B, N) bool and
        anchors (B, N, 4), with N the levels' top-k counts summed."""
        anchors_np, counts = self._anchors(image_hw)
        dev = logits_l[0].device
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cands = []
        for lvl in range(len(counts)):
            lvl_anchors = torch.as_tensor(
                anchors_np[offsets[lvl]: offsets[lvl + 1]], device=dev)
            cands.append(_retina_level_candidates(
                logits_l[lvl], regs_l[lvl], lvl_anchors, self.score_thresh,
                self.topk_candidates, self.box_reg_weights))
        return tuple(torch.cat(t, dim=1) for t in zip(*cands))

    def postprocess(self, logits_l, regs_l, image_hw, scale,
                    orig_size) -> Dict[str, torch.Tensor]:
        """Candidates, NMS and rescaling from the head's per-level outputs."""
        boxes, scores, classes, valid, anchors = self.candidates(
            logits_l, regs_l, image_hw)

        keep_idx, keep_valid = cuda_batched_nms(
            boxes, scores, classes, self.nms_thresh, self.max_dets,
            valid=valid)
        keep = keep_idx.long()
        keep4 = keep[..., None].expand(-1, -1, 4)
        scale = scale.float()[:, None, None]
        orig = orig_size.float()

        def rescaled(t):
            return box_ops.clip(torch.gather(t, 1, keep4) / scale,
                                orig[:, 0:1], orig[:, 1:2])

        out = {
            "boxes": rescaled(boxes),
            "scores": torch.gather(scores, 1, keep),
            "classes": torch.gather(classes, 1, keep),
            "valid": keep_valid,
        }
        if self.with_anchor:
            out["anchors"] = rescaled(anchors)
        return out


class DeformableConvRetinaNet(RetinaNet):
    """RetinaNet with modulated deformable convs (``DFConv2d``) in the head's
    subnets."""

    def __init__(self, cfg):
        super().__init__(cfg, use_dcn=True)


class CenternessRetinaNet(RetinaNet):
    """RetinaNet with FCOS-style assignment at the anchor centres."""

    def __init__(self, cfg):
        super().__init__(cfg, assign_mode="fcos")


class NearestRetinaNet(RetinaNet):
    """RetinaNet with nearest-point assignment."""

    def __init__(self, cfg):
        super().__init__(cfg, assign_mode="nearest")
