"""Rotated Region Proposal Network (counterpart of
``slenderobjdet_tpu/models/proposal_generator/rrpn.py``:
``clip_rotated_boxes`` and ``RotatedRPN``; detectron2's RRPN, which the
reference's rotated two-stage configs select with PROPOSAL_GENERATOR.NAME
"RRPN").

The RPN (``rpn.py``) with the rotated substitutions: XYWHA anchors
(``RotatedAnchorGeneratorSpec``, SIZES x ASPECT_RATIOS x ANGLES a cell),
the IoU matcher with low-quality matches over the exact rotated IoU (one
launch of the IoU kernel an image on CUDA tensors), Box2BoxTransformRotated
targets, and proposals found by each level's top-k (ties to the lower
index, as ``jax.lax.top_k``), the rotated decode, detectron2's rotated clip
(only boxes within 1 degree of horizontal are clipped), the min-size mask
on (w, h), and one level-aware rotated NMS keeping ``POST_NMS_TOPK`` slots:
each level's centres moved by ``level * 4096`` in float32
(``ops/rotated.py:offset_boxes``; one launch of the NMS kernel a call on
CUDA tensors).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...ops.rotated import (apply_rotated_deltas, get_rotated_deltas, offset_boxes,
                            pairwise_rotated_iou, rotated_nms)
from ...ops.topk import top_k_by_index
from ..anchors import RotatedAnchorGeneratorSpec
from ..matchers import iou_matcher
from .rpn import RPN


def clip_rotated_boxes(boxes: torch.Tensor, h, w,
                       clip_angle_threshold: float = 1.0) -> torch.Tensor:
    """detectron2's RotatedBoxes.clip: the angle normalised into [-180,
    180), then only nearly horizontal boxes (|angle| <= threshold) clipped
    to the image through their XYXY form. ``h``, ``w`` broadcast against
    the boxes' leading dimensions."""
    cx, cy, bw, bh, a = boxes.unbind(-1)
    a = torch.remainder(a + 180.0, 360.0) - 180.0

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0), hi)

    x1 = clip(cx - bw / 2.0, w)
    y1 = clip(cy - bh / 2.0, h)
    x2 = clip(cx + bw / 2.0, w)
    y2 = clip(cy + bh / 2.0, h)
    horiz = a.abs() <= clip_angle_threshold
    cx = torch.where(horiz, (x1 + x2) / 2.0, cx)
    cy = torch.where(horiz, (y1 + y2) / 2.0, cy)
    bw = torch.where(horiz, x2 - x1, bw)
    bh = torch.where(horiz, y2 - y1, bh)
    return torch.stack([cx, cy, bw, bh, a], dim=-1)


class RotatedRPN(RPN):
    """RPN over XYWHA anchors; its head is ``StandardRPNHead(box_dim=5)``."""

    def __init__(self, cfg, strides: Sequence[int]):
        super().__init__(cfg, strides)
        self.anchor_spec = RotatedAnchorGeneratorSpec(cfg, strides)
        self.num_cell_anchors = self.anchor_spec.num_cell_anchors[0]
        w = tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS)
        self.bbox_reg_weights = w + (1.0,) * (5 - len(w))

    def _match(self, anchors, gt_boxes, gt_valid):
        # detectron2's RRPN keeps the plain Matcher, over the rotated IoU
        return iou_matcher(anchors, gt_boxes, gt_valid, self.iou_thresholds,
                           self.iou_labels, allow_low_quality_matches=True,
                           pairwise_fn=pairwise_rotated_iou)

    def target_deltas(self, anchors, matched_boxes, sel_pos):
        off = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=anchors.device)
        safe = torch.where(sel_pos[..., None], matched_boxes, anchors[None] + off)
        return get_rotated_deltas(anchors[None].expand_as(safe), safe,
                                  weights=self.bbox_reg_weights)

    # ------------------------------------------------------------ proposals
    def candidates(self, anchors: torch.Tensor, counts: Sequence[int], logits, deltas,
                   image_sizes, train: bool):
        """The NMS's input from anchors (N, 5): each level's top-k
        (k = min(PRE_NMS_TOPK, count)) decoded and clipped. Returns boxes
        (B, K, 5), scores (B, K) (the logits), the min-size mask (B, K), the
        source anchors (B, K, 5) and each candidate's level (B, K)."""
        pre_k = self.pre_nms_topk[train]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        boxes, scores, sources, levels = [], [], [], []
        for lvl in range(len(counts)):
            sl = slice(int(offsets[lvl]), int(offsets[lvl + 1]))
            k = min(pre_k, int(counts[lvl]))
            top_scores, top_idx = top_k_by_index(logits[:, sl], k)
            sel_deltas = torch.gather(deltas[:, sl], 1, top_idx[..., None].expand(-1, -1, 5))
            sel_anchors = anchors[sl][top_idx]
            boxes.append(apply_rotated_deltas(sel_deltas, sel_anchors,
                                              weights=self.bbox_reg_weights))
            scores.append(top_scores)
            sources.append(sel_anchors)
            levels.append(torch.full_like(top_idx, lvl))
        hw = torch.as_tensor(image_sizes, device=logits.device).float()
        boxes = clip_rotated_boxes(torch.cat(boxes, 1), hw[:, 0:1], hw[:, 1:2])
        wh_ok = (boxes[..., 2] > self.min_size) & (boxes[..., 3] > self.min_size)
        return boxes, torch.cat(scores, 1), wh_ok, torch.cat(sources, 1), torch.cat(levels, 1)

    def proposals(self, anchors: torch.Tensor, counts: Sequence[int], logits, deltas,
                  image_sizes, train: bool, with_anchors: bool = False):
        """-> (B, K, 5) proposals in image coordinates, (B, K) scores, (B, K)
        valid, K = POST_NMS_TOPK; ``with_anchors`` also each kept proposal's
        source anchor (B, K, 5)."""
        boxes, scores, wh_ok, sources, levels = self.candidates(
            anchors, counts, logits, deltas, image_sizes, train)
        keep_idx, keep_valid = rotated_nms(offset_boxes(boxes, levels), scores,
                                           self.nms_thresh, self.post_nms_topk[train],
                                           valid=wh_ok)
        keep = keep_idx.long()
        keep5 = keep[..., None].expand(-1, -1, 5)
        out = (torch.gather(boxes, 1, keep5), torch.gather(scores, 1, keep), keep_valid)
        if with_anchors:
            out += (torch.gather(sources, 1, keep5),)
        return out
