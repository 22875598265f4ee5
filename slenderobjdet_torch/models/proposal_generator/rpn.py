"""Region Proposal Network (counterpart of
``slenderobjdet_tpu/models/proposal_generator/rpn.py``: ``StandardRPNHead``
and ``RPN``, the reference's ``RPNWNM``, detectron2's RPN with a pluggable
matcher, ``MODEL.RPN.MATCHER.TYPE`` "Origin" or "TopK").

Fixed-shape, as in the JAX package:
- anchor labelling and the random 256 at 0.5 subsampling are masks
  (``models/sampling.py``), the priorities drawn from a ``torch.Generator``;
  the labels need no gradient and are made image by image under
  ``torch.no_grad()``;
- find_top_rpn_proposals becomes per-level top-k (ties to the lower index,
  as ``jax.lax.top_k``), decoding, clipping to the image's unpadded size,
  the min-size mask, and one level-aware NMS keeping ``POST_NMS_TOPK``
  slots (``ops/nms.py:level_batched_nms``: on CUDA tensors one launch of
  the NMS kernel over rows of (image, level)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import optax_sigmoid_ce, smooth_l1_loss
from ...ops.nms import level_batched_nms
from ...ops.topk import top_k_by_index
from ...structures import boxes as box_ops
from ..anchors import AnchorGeneratorSpec
from ..layers import Conv2d
from ..matchers import iou_matcher, topk_matcher
from ..sampling import subsample_labels


class StandardRPNHead(nn.Module):
    """One shared 3x3 conv and two 1x1 convs (objectness, deltas) over every
    level; outputs in float32."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4):
        super().__init__()
        self.num_anchors = num_anchors
        self.box_dim = box_dim
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * box_dim, 1)

    def forward(self, feats: List[torch.Tensor]):
        """feats: list of (B, C, H_l, W_l). Returns per-level (B, H*W*A)
        logits and (B, H*W*A, box_dim) deltas, rows cell by cell in
        row-major (h, w) order, anchor-minor: the order of
        ``anchors_per_level``."""
        logits, regs = [], []
        for x in feats:
            b = x.shape[0]
            t = F.relu(self.conv(x))
            logits.append(self.objectness_logits(t).float()
                          .permute(0, 2, 3, 1).reshape(b, -1))
            regs.append(self.anchor_deltas(t).float()
                        .permute(0, 2, 3, 1).reshape(b, -1, self.box_dim))
        return logits, regs


class RPN:
    """RPN logic over the head's outputs (anchors are host-side constants)."""

    def __init__(self, cfg, strides: Sequence[int]):
        r = cfg.MODEL.RPN
        self.in_features = list(r.IN_FEATURES)
        self.strides = list(strides)
        self.anchor_spec = AnchorGeneratorSpec(cfg, strides)
        self.num_cell_anchors = self.anchor_spec.num_cell_anchors[0]
        self.batch_size_per_image = r.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = r.POSITIVE_FRACTION
        self.iou_thresholds = list(r.IOU_THRESHOLDS)
        self.iou_labels = list(r.IOU_LABELS)
        self.matcher_type = r.MATCHER.TYPE
        self.matcher_topk = r.MATCHER.TOPK
        self.matcher_chunk = r.MATCHER.CHUNK
        self.bbox_reg_weights = tuple(r.BBOX_REG_WEIGHTS)
        self.smooth_l1_beta = r.SMOOTH_L1_BETA
        self.loss_weight = r.LOSS_WEIGHT
        self.pre_nms_topk = {True: r.PRE_NMS_TOPK_TRAIN, False: r.PRE_NMS_TOPK_TEST}
        self.post_nms_topk = {True: r.POST_NMS_TOPK_TRAIN, False: r.POST_NMS_TOPK_TEST}
        self.nms_thresh = r.NMS_THRESH
        self.min_size = cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE

    def _match(self, anchors, gt_boxes, gt_valid):
        if self.matcher_type == "TopK":
            return topk_matcher(anchors, gt_boxes, gt_valid, self.iou_thresholds,
                                self.iou_labels, k=self.matcher_topk)
        return iou_matcher(anchors, gt_boxes, gt_valid, self.iou_thresholds,
                           self.iou_labels, allow_low_quality_matches=True,
                           chunk=self.matcher_chunk)

    # ----------------------------------------------------------------- loss
    def losses(self, anchors, logits, deltas, gt_boxes, gt_classes, gt_valid,
               generator: Optional[torch.Generator] = None,
               priorities: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """anchors (N, 4); logits (B, N); deltas (B, N, 4); gt padded per
        image. The subsampling priorities are drawn from ``generator``, image
        by image, or taken from ``priorities`` (one pair of (N,) tensors an
        image)."""
        del gt_classes
        B = logits.shape[0]
        sel_pos, sel_neg, matched = [], [], []
        with torch.no_grad():
            for b in range(B):
                matched_idx, match_labels = self._match(anchors, gt_boxes[b], gt_valid[b])
                p, n = subsample_labels(
                    match_labels == 1, match_labels == 0, self.batch_size_per_image,
                    self.positive_fraction, generator,
                    None if priorities is None else priorities[b])
                sel_pos.append(p)
                sel_neg.append(n)
                matched.append(gt_boxes[b][matched_idx.long()])
        sel_pos, sel_neg = torch.stack(sel_pos), torch.stack(sel_neg)
        matched_boxes = torch.stack(matched)

        # static (B the local batch): under data parallelism the mean of the
        # processes' losses is already the global sum over 256 x global B
        normalizer = float(self.batch_size_per_image * B)
        obj_loss = torch.where(sel_pos | sel_neg,
                               optax_sigmoid_ce(logits, sel_pos.float()),
                               0.0).sum() / normalizer

        target_deltas = self.target_deltas(anchors, matched_boxes, sel_pos)
        reg_loss = torch.where(
            sel_pos[..., None],
            smooth_l1_loss(deltas, target_deltas, self.smooth_l1_beta),
            0.0).sum() / normalizer
        return {"loss_rpn_cls": obj_loss * self.loss_weight,
                "loss_rpn_loc": reg_loss * self.loss_weight}

    def target_deltas(self, anchors, matched_boxes, sel_pos):
        """The regression targets (B, N, 4); anchors that are not sampled
        positives get a safe dummy target before the encoding (a where after
        it leaks a NaN gradient)."""
        safe_boxes = torch.where(sel_pos[..., None], matched_boxes, anchors[None] + 1.0)
        return box_ops.get_deltas(anchors[None].expand_as(safe_boxes), safe_boxes,
                                  weights=self.bbox_reg_weights)

    # ------------------------------------------------------------ proposals
    def candidates(self, anchors: torch.Tensor, counts: Sequence[int], logits,
                   deltas, image_sizes, train: bool):
        """The NMS's input from anchors (N, 4) on the logits' device: each
        level's top-k (k = min(PRE_NMS_TOPK, count)) decoded and clipped to
        the image's (h, w) ``image_sizes`` (B, 2). Returns boxes (B, K, 4),
        scores (B, K) (the logits), the min-size mask (B, K), the source
        anchors (B, K, 4) and the levels' k, K their sum."""
        pre_k = self.pre_nms_topk[train]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        dev = logits.device
        boxes, scores, sources, ks = [], [], [], []
        for lvl in range(len(counts)):
            sl = slice(int(offsets[lvl]), int(offsets[lvl + 1]))
            k = min(pre_k, int(counts[lvl]))
            top_scores, top_idx = top_k_by_index(logits[:, sl], k)
            sel_deltas = torch.gather(deltas[:, sl], 1, top_idx[..., None].expand(-1, -1, 4))
            sel_anchors = anchors[sl][top_idx]
            boxes.append(box_ops.apply_deltas(sel_deltas, sel_anchors,
                                              weights=self.bbox_reg_weights))
            scores.append(top_scores)
            sources.append(sel_anchors)
            ks.append(k)
        hw = torch.as_tensor(image_sizes, device=dev).float()
        boxes = box_ops.clip(torch.cat(boxes, 1), hw[:, 0:1], hw[:, 1:2])
        wh_ok = (((boxes[..., 2] - boxes[..., 0]) > self.min_size)
                 & ((boxes[..., 3] - boxes[..., 1]) > self.min_size))
        return boxes, torch.cat(scores, 1), wh_ok, torch.cat(sources, 1), ks

    def proposals(self, anchors: torch.Tensor, counts: Sequence[int], logits,
                  deltas, image_sizes, train: bool, with_anchors: bool = False):
        """-> (B, K, 4) proposal boxes in image coordinates, (B, K) scores,
        (B, K) valid, K = POST_NMS_TOPK; ``with_anchors`` also returns each
        kept proposal's source anchor (B, K, 4), clipped to the image."""
        boxes, scores, wh_ok, sources, ks = self.candidates(
            anchors, counts, logits, deltas, image_sizes, train)
        keep_idx, keep_valid = level_batched_nms(
            boxes, scores, ks, self.nms_thresh, self.post_nms_topk[train], valid=wh_ok)
        keep = keep_idx.long()
        keep4 = keep[..., None].expand(-1, -1, 4)
        out = (torch.gather(boxes, 1, keep4), torch.gather(scores, 1, keep), keep_valid)
        if with_anchors:
            hw = torch.as_tensor(image_sizes, device=boxes.device).float()
            out += (box_ops.clip(torch.gather(sources, 1, keep4), hw[:, 0:1], hw[:, 1:2]),)
        return out
