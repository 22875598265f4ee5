"""Rotated ROI heads, RROIHeads (counterpart of
``slenderobjdet_tpu/models/roi_heads/rotated.py``: ``sample_rotated_proposals``
and ``RotatedROIHeads``; detectron2's RROIHeads, which the reference's
rotated two-stage configs select with ROI_HEADS.NAME "RROIHeads").

StandardROIHeads (``roi_heads.py``) with the rotated substitutions: the
proposal-gt matching over the exact rotated IoU, ROIAlignRotated pooling
(``ops/roi_align_rotated.py``), class-specific XYWHA deltas under
ROI_BOX_HEAD.BBOX_REG_WEIGHTS (10, 5, 5, 5, 1), and inference as the JAX
package's: softmax scores, the top 1000 (proposal, class) pairs (ties to
the lower index), the score threshold as a mask and class-aware rotated
NMS through the centre offset ``class * 4096`` (one launch of the NMS
kernel a call on CUDA tensors). Boxes are not clipped; the detections are
XYWHA in the original image (cx, cy, w, h over the scale, the angle as it
is).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ...ops.roi_align_rotated import multilevel_roi_align_rotated_fused
from ...ops.rotated import (apply_rotated_deltas, get_rotated_deltas, offset_boxes,
                            pairwise_rotated_iou, rotated_nms)
from ...ops.topk import top_k_by_index
from .roi_heads import ROIBoxModule, StandardROIHeads, sample_proposals


def sample_rotated_proposals(proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
                             num_samples, positive_fraction, iou_thresholds, iou_labels,
                             num_classes, append_gt=True, generator=None, priorities=None):
    """detectron2's RROIHeads.label_and_sample_proposals on one image:
    ``sample_proposals`` over (R, 5) proposals and (G, 5) gt with the rotated
    IoU."""
    return sample_proposals(proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
                            num_samples, positive_fraction, iou_thresholds, iou_labels,
                            num_classes, append_gt, generator, priorities,
                            pairwise_fn=pairwise_rotated_iou)


class RotatedROIHeads(StandardROIHeads):
    box_dim = 5

    def __init__(self, cfg, strides: Sequence[int]):
        super().__init__(cfg, strides)
        w = tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)
        self.bbox_reg_weights = w + (1.0,) * (5 - len(w))

    sample_proposals = staticmethod(sample_rotated_proposals)

    def pool(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """feats: the ROI levels, (B, C, H_l, W_l) each; rois (B, R, 5) ->
        (B, R, P, P, C) float32, differentiable in the features."""
        return multilevel_roi_align_rotated_fused(feats, self.strides, rois,
                                                  output_size=self.pooler_resolution,
                                                  sampling_ratio=self.sampling_ratio)

    def target_deltas(self, rois, target_boxes, fg):
        off = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=rois.device)
        safe_targets = torch.where(fg[..., None], target_boxes, rois + off)
        return get_rotated_deltas(rois, safe_targets, weights=self.bbox_reg_weights)

    # ------------------------------------------------------------ inference
    def candidates(self, module: ROIBoxModule, feats, proposals, prop_valid):
        """The class-aware NMS's input: the top min(1000, R x C) (proposal,
        class) pairs by softmax score (pairs of invalid proposals score 0),
        their decoded boxes (B, K, 5), scores (B, K), classes (B, K) int32,
        the score-threshold mask (B, K) and the proposal row of each."""
        scores, deltas = module(self.pool(feats, proposals))
        probs = F.softmax(scores, dim=-1)[..., :-1]                 # (B, R, C)
        B, R, C = probs.shape
        if self.cls_agnostic:
            boxes = apply_rotated_deltas(deltas, proposals, weights=self.bbox_reg_weights)
            boxes = boxes[:, :, None, :].expand(B, R, C, 5)
        else:
            boxes = apply_rotated_deltas(deltas.reshape(B, R, C, 5), proposals[:, :, None, :],
                                         weights=self.bbox_reg_weights)
        flat_scores = torch.where(prop_valid[..., None], probs, 0.0).reshape(B, R * C)
        top_scores, top_idx = top_k_by_index(flat_scores, min(1000, R * C))
        sel_boxes = torch.gather(boxes.reshape(B, R * C, 5), 1,
                                 top_idx[..., None].expand(-1, -1, 5))
        return (sel_boxes, top_scores, (top_idx % C).to(torch.int32),
                top_scores > self.score_thresh, top_idx // C)

    def inference(self, module: ROIBoxModule, feats, proposals, prop_valid, scales,
                  orig_sizes, prop_anchors: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """Detections: boxes (B, D, 5) XYWHA in original image coordinates,
        scores, classes int32, valid. ``orig_sizes`` and ``prop_anchors`` are
        taken for the interface's sake: rotated boxes are not clipped, and
        the anchor-diagnosis chain is axis-aligned only."""
        del orig_sizes, prop_anchors
        sel_boxes, top_scores, sel_cls, valid, _ = self.candidates(
            module, feats, proposals, prop_valid)
        keep_idx, keep_valid = rotated_nms(offset_boxes(sel_boxes, sel_cls), top_scores,
                                           self.nms_thresh, self.max_dets, valid=valid)
        keep = keep_idx.long()
        kept = torch.gather(sel_boxes, 1, keep[..., None].expand(-1, -1, 5))
        scale = scales.float()[:, None, None]
        return {"boxes": torch.cat([kept[..., :4] / scale, kept[..., 4:]], dim=-1),
                "scores": torch.gather(top_scores, 1, keep),
                "classes": torch.gather(sel_cls, 1, keep),
                "valid": keep_valid}
