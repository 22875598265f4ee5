"""Standard ROI heads, the box branch (counterpart of
``slenderobjdet_tpu/models/roi_heads/roi_heads.py``: ``FastRCNNConvFCHead``,
``FastRCNNOutputLayers``, ``ROIBoxModule``, ``sample_proposals`` and
``StandardROIHeads``; detectron2's StandardROIHeads with the reference's
ProposalVisibleHead and FastRCNNOutputLayersWithAnchor plumbing).

Fixed-shape, as in the JAX package: proposal sampling (512 at 0.25, the gt
appended, detectron2's label_and_sample_proposals) packs the selected rows
to the front by a stable argsort of the selection mask, so that the pooler
and the box head always see the same shapes. Pooling is the single-gather
multilevel RoIAlign (``ops/roi_align.py``), channels last, so that the
flattened (P, P, C) input of ``fc1`` is in the JAX package's order and its
weight carries over as the Flax kernel transposed. Inference is softmax,
the top 1000 of the R x C (proposal, class) pairs (ties to the lower index),
the score threshold as a mask, and class-aware NMS keeping
``TEST.DETECTIONS_PER_IMAGE`` slots (on CUDA tensors the NMS kernel).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import smooth_l1_loss
from ...ops.nms import cuda_batched_nms
from ...ops.roi_align import multilevel_roi_align, multilevel_roi_align_fused
from ...ops.topk import top_k_by_index
from ...parallel.multihost import global_sum, process_share
from ...structures import boxes as box_ops
from ..layers import Linear
from ..matchers import iou_matcher
from ..sampling import subsample_labels


class FastRCNNConvFCHead(nn.Module):
    """``num_fc`` fully connected layers with relu over the flattened
    (P, P, C) pooled features."""

    def __init__(self, in_features: int, num_fc: int = 2, fc_dim: int = 1024):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(in_features if i == 0 else fc_dim,
                                                 fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (..., P, P, C)
        x = x.flatten(-3)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    """Class scores (C + 1, background last) and class-specific (or
    agnostic) box deltas, in float32."""

    def __init__(self, in_features: int, num_classes: int,
                 cls_agnostic: bool = False, box_dim: int = 4):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes + 1)
        self.bbox_pred = Linear(in_features,
                                (1 if cls_agnostic else num_classes) * box_dim)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class ROIBoxModule(nn.Module):
    """Box head and output layers over pooled features, computed in
    ``dtype``."""

    def __init__(self, head: FastRCNNConvFCHead, outputs: FastRCNNOutputLayers,
                 dtype: torch.dtype):
        super().__init__()
        self.head = head
        self.outputs = outputs
        self.dtype = dtype

    def forward(self, pooled: torch.Tensor):   # (..., P, P, C)
        return self.outputs(self.head(pooled.to(self.dtype)))


def sample_proposals(
    proposals: torch.Tensor,     # (R, 4)
    prop_valid: torch.Tensor,    # (R,)
    gt_boxes: torch.Tensor,      # (G, 4)
    gt_classes: torch.Tensor,    # (G,)
    gt_valid: torch.Tensor,      # (G,)
    num_samples: int,
    positive_fraction: float,
    iou_thresholds: Sequence[float],
    iou_labels: Sequence[int],
    num_classes: int,
    append_gt: bool = True,
    generator: Optional[torch.Generator] = None,
    priorities: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pairwise_fn=None,
):
    """detectron2's label_and_sample_proposals on one image, masked. Returns
    the sampled rows packed to the front: rois (S, 4), classes (S,) int32
    (num_classes = background), regression target boxes (S, 4) and row_valid
    (S,), S = min(num_samples, candidates). The subsampling priorities come
    from ``generator`` or ``priorities`` (two (candidates,) tensors).
    ``pairwise_fn`` replaces the box IoU (the rotated heads' (R, 5) boxes)."""
    if append_gt:
        proposals = torch.cat([proposals, gt_boxes], 0)
        prop_valid = torch.cat([prop_valid, gt_valid], 0)

    matched_idx, match_labels = iou_matcher(
        proposals, gt_boxes, gt_valid, iou_thresholds, iou_labels,
        allow_low_quality_matches=False, pairwise_fn=pairwise_fn)
    pos = (match_labels == 1) & prop_valid
    neg = (match_labels == 0) & prop_valid
    sel_pos, sel_neg = subsample_labels(pos, neg, num_samples, positive_fraction,
                                        generator, priorities)
    selected = sel_pos | sel_neg

    # the selected rows to the front, in index order (a stable sort); a
    # config may offer fewer candidates than num_samples
    num_samples = min(num_samples, proposals.shape[0])
    order = torch.argsort((~selected).to(torch.int8), stable=True)
    rows = order[:num_samples]
    row_valid = torch.arange(num_samples, device=rows.device) < selected.sum()

    matched = matched_idx.long()[rows]
    classes = torch.where(sel_pos[rows], gt_classes.long()[matched], num_classes)
    classes = torch.where(row_valid, classes, num_classes).to(torch.int32)
    return proposals[rows], classes, gt_boxes[matched], row_valid


class StandardROIHeads:
    """ROI box logic (the box module lives on the detector as ``roi_box``)."""

    box_dim = 4

    def __init__(self, cfg, strides: Sequence[int]):
        h = cfg.MODEL.ROI_HEADS
        b = cfg.MODEL.ROI_BOX_HEAD
        self.num_classes = h.NUM_CLASSES
        self.in_features = list(h.IN_FEATURES)
        self.strides = list(strides)
        self.batch_size_per_image = h.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = h.POSITIVE_FRACTION
        self.iou_thresholds = list(h.IOU_THRESHOLDS)
        self.iou_labels = list(h.IOU_LABELS)
        self.append_gt = h.PROPOSAL_APPEND_GT
        self.score_thresh = h.SCORE_THRESH_TEST
        self.nms_thresh = h.NMS_THRESH_TEST
        self.pooler_resolution = b.POOLER_RESOLUTION
        self.sampling_ratio = max(b.POOLER_SAMPLING_RATIO, 2)
        self.bbox_reg_weights = tuple(b.BBOX_REG_WEIGHTS)
        self.smooth_l1_beta = b.SMOOTH_L1_BETA
        self.cls_agnostic = b.CLS_AGNOSTIC_BBOX_REG
        self.num_fc = max(b.NUM_FC, 1)
        self.fc_dim = b.FC_DIM
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE

    def build_module(self, in_channels: int, dtype: torch.dtype) -> ROIBoxModule:
        P = self.pooler_resolution
        return ROIBoxModule(
            FastRCNNConvFCHead(P * P * in_channels, self.num_fc, self.fc_dim),
            FastRCNNOutputLayers(self.fc_dim, self.num_classes, self.cls_agnostic,
                                 self.box_dim),
            dtype)

    def pool(self, feats, rois: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """feats: the ROI levels, (B, C, H_l, W_l) each; rois (B, R, 4) ->
        (B, R, P, P, C) float32, differentiable in the features. ``fused``
        False pools every level and selects (``multilevel_roi_align``), the
        all-level path ``tools/rcnn_profile.py --all-level-pool`` times."""
        fn = multilevel_roi_align_fused if fused else multilevel_roi_align
        return fn(feats, self.strides, rois, output_size=self.pooler_resolution,
                  sampling_ratio=self.sampling_ratio)

    # ----------------------------------------------------------------- loss
    def losses(self, module: ROIBoxModule, feats, proposals, prop_valid,
               gt_boxes, gt_classes, gt_valid,
               generator: Optional[torch.Generator] = None,
               priorities: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """feats: the ROI levels; proposals (B, R, 4) and prop_valid (B, R)
        without gradient; priorities, if given, one pair an image."""
        with torch.no_grad():
            sampled = [self.sample_proposals(
                proposals[b], prop_valid[b], gt_boxes[b], gt_classes[b], gt_valid[b],
                self.batch_size_per_image, self.positive_fraction,
                self.iou_thresholds, self.iou_labels, self.num_classes,
                self.append_gt, generator,
                None if priorities is None else priorities[b])
                for b in range(proposals.shape[0])]
        rois, classes, target_boxes, row_valid = (torch.stack(t) for t in zip(*sampled))

        scores, deltas = module(self.pool(feats, rois))  # (B,S,C+1), (B,S,4C)

        fg = (classes < self.num_classes) & row_valid
        # the global batch's sampled rows and foreground, one all-reduce
        num_valid, num_fg = global_sum(torch.stack([row_valid.sum(), fg.sum()]))
        valid_share = process_share(torch.clamp(num_valid.float(), min=1.0))

        # softmax CE, the mean over the sampled rows (d2's cross_entropy)
        logp = F.log_softmax(scores, dim=-1)
        ce = -torch.gather(logp, -1, classes.long()[..., None])[..., 0]
        cls_loss = torch.where(row_valid, ce, 0.0).sum() / valid_share

        # the gt class's deltas
        tgt_deltas = self.target_deltas(rois, target_boxes, fg)
        k = self.box_dim
        if self.cls_agnostic:
            sel_deltas = deltas
        else:
            d = deltas.reshape(*deltas.shape[:-1], self.num_classes, k)
            cls_idx = classes.long().clamp(0, self.num_classes - 1)
            sel_deltas = torch.gather(
                d, -2, cls_idx[..., None, None].expand(*cls_idx.shape, 1, k))[..., 0, :]
        reg = smooth_l1_loss(sel_deltas, tgt_deltas, self.smooth_l1_beta)
        reg_loss = torch.where(fg[..., None], reg, 0.0).sum() / valid_share
        return {"loss_cls": cls_loss, "loss_box_reg": reg_loss, "num_fg": num_fg}

    sample_proposals = staticmethod(sample_proposals)

    def target_deltas(self, rois, target_boxes, fg):
        """The regression targets; rows that are not foreground get a safe
        target before the encoding (a where after it leaks a NaN
        gradient)."""
        safe_targets = torch.where(fg[..., None], target_boxes, rois + 1.0)
        return box_ops.get_deltas(rois, safe_targets, weights=self.bbox_reg_weights)

    # ------------------------------------------------------------ inference
    def candidates(self, module: ROIBoxModule, feats, proposals, prop_valid):
        """The class-aware NMS's input: the top min(1000, R x C) of the
        (proposal, class) pairs by softmax score (ties to the lower index;
        pairs of invalid proposals score 0), their decoded boxes (B, K, 4),
        scores (B, K), classes (B, K) int32, the score-threshold mask (B, K)
        and the proposal row of each (B, K)."""
        scores, deltas = module(self.pool(feats, proposals))
        probs = F.softmax(scores, dim=-1)[..., :-1]                 # (B, R, C)
        B, R, C = probs.shape
        boxes = box_ops.apply_deltas(deltas, proposals, weights=self.bbox_reg_weights)
        boxes = (boxes[:, :, None, :].expand(B, R, C, 4) if self.cls_agnostic
                 else boxes.reshape(B, R, C, 4))

        flat_scores = torch.where(prop_valid[..., None], probs, 0.0).reshape(B, R * C)
        top_scores, top_idx = top_k_by_index(flat_scores, min(1000, R * C))
        sel_boxes = torch.gather(boxes.reshape(B, R * C, 4), 1,
                                 top_idx[..., None].expand(-1, -1, 4))
        return (sel_boxes, top_scores, (top_idx % C).to(torch.int32),
                top_scores > self.score_thresh, top_idx // C)

    def inference(self, module: ROIBoxModule, feats, proposals, prop_valid,
                  scales, orig_sizes,
                  prop_anchors: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Detections in original image coordinates: boxes (B, D, 4), scores,
        classes int32, valid. ``prop_anchors`` (B, R, 4), if given, adds each
        detection's source proposal and that proposal's anchor
        (``det_proposals``, ``anchors``), rescaled and clipped like its box."""
        sel_boxes, top_scores, sel_cls, valid, rows = self.candidates(
            module, feats, proposals, prop_valid)
        keep_idx, keep_valid = cuda_batched_nms(sel_boxes, top_scores, sel_cls,
                                                self.nms_thresh, self.max_dets, valid=valid)
        keep = keep_idx.long()
        keep4 = keep[..., None].expand(-1, -1, 4)
        scale = scales.float()[:, None, None]
        orig = orig_sizes.float()

        def rescaled(t):
            return box_ops.clip(torch.gather(t, 1, keep4) / scale,
                                orig[:, 0:1], orig[:, 1:2])

        out = {"boxes": rescaled(sel_boxes), "scores": torch.gather(top_scores, 1, keep),
               "classes": torch.gather(sel_cls, 1, keep), "valid": keep_valid}
        if prop_anchors is not None:
            rows = rows[..., None].expand(-1, -1, 4)
            out["det_proposals"] = rescaled(torch.gather(proposals, 1, rows))
            out["anchors"] = rescaled(torch.gather(prop_anchors, 1, rows))
        return out
