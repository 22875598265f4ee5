"""Anchor/proposal matchers as pure functions on one image (counterpart of
``slenderobjdet_tpu/models/matchers.py``; detectron2's ``Matcher`` and the
reference's ``TopKMatcher`` on fixed shapes).

gt tensors are padded with a validity mask; outputs are per-anchor
``(matched_idx, match_labels)`` with the labels taken from cfg IOU_LABELS
(e.g. 0 = background, -1 = ignore, 1 = foreground; int8, which a Python scalar
in ``torch.where`` leaves as it is). ``torch.argmax`` takes the
first maximum, as ``jnp.argmax`` does, so ties go to the lowest gt index, and
with no valid gt every IoU is -1 and the index is 0. The low-quality set
compares the very IoU values that were computed once, never a recomputation.
Callers that need no gradient (all of them) run these under
``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..structures import boxes as box_ops


def _matcher_core_chunked(anchors, gt_boxes, gt_valid, pairwise_fn,
                          allow_low_quality_matches, chunk):
    """(matched_vals, matched_idx, lq) streamed over anchor chunks so that
    the full (G, N) IoU matrix never lives at once.

    One pass: each chunk's IoU is computed once; the per-anchor max and
    argmax over gt are chunk-local, the per-gt maximum combines across chunks
    (max is order-exact), and the low-quality tie set comes from the same
    computed values through
        iou == global_max  <=>  (iou == chunk_max) & (chunk_max == global_max)
    (exact, since iou <= chunk_max <= global_max elementwise). A second pass
    that recomputes the IoU could differ by an ulp and drop exact ties."""
    n = anchors.shape[0]
    mv, mi, pg, best = [], [], [], []
    for start in range(0, n, chunk):
        iou = pairwise_fn(gt_boxes, anchors[start:start + chunk])   # (G, C)
        iou = torch.where(gt_valid[:, None], iou, -1.0)
        chunk_pg = iou.amax(dim=1)                                  # (G,)
        mv.append(iou.amax(dim=0))
        mi.append(torch.argmax(iou, dim=0))
        pg.append(chunk_pg)
        # (G, C) bool: N*G bits over all chunks, not N*G floats
        best.append(iou == chunk_pg[:, None])
    matched_vals = torch.cat(mv)
    matched_idx = torch.cat(mi).to(torch.int32)

    lq = None
    if allow_low_quality_matches:
        global_pg = torch.stack(pg).amax(dim=0)                     # (G,)
        gate = gt_valid & (global_pg > 0)
        lq = torch.cat([
            (b & ((p == global_pg) & gate)[:, None]).any(dim=0)
            for b, p in zip(best, pg)])
    return matched_vals, matched_idx, lq


def _threshold_labels(matched_vals, thresholds, labels):
    match_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int8,
                              device=matched_vals.device)
    for lo, label in zip(list(thresholds), labels[1:]):
        match_labels = torch.where(matched_vals >= lo, label, match_labels)
    return match_labels


def iou_matcher(
    anchors: torch.Tensor,         # (N, 4), or (N, 5) XYWHA with pairwise_fn
    gt_boxes: torch.Tensor,        # (G, 4), or (G, 5)
    gt_valid: torch.Tensor,        # (G,) bool
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality_matches: bool = True,
    pairwise_fn=None,
    chunk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher semantics on padded gt.

    ``pairwise_fn(gt, anchors) -> (G, N)`` overrides the similarity.
    ``chunk`` > 0 streams the match over anchor chunks of that size: the same
    algorithm from one computation of each chunk's IoU, equal to the one-shot
    result on exactly representable boxes.

    Returns:
        matched_idx: (N,) int32 index into gt (0 when no gt is valid)
        match_labels: (N,) int8 from ``labels`` per threshold bin
    """
    if pairwise_fn is None:
        pairwise_fn = box_ops.pairwise_iou
    if chunk and anchors.shape[0] > chunk:
        matched_vals, matched_idx, lq = _matcher_core_chunked(
            anchors, gt_boxes, gt_valid, pairwise_fn,
            allow_low_quality_matches, chunk)
    else:
        iou = pairwise_fn(gt_boxes, anchors)                        # (G, N)
        iou = torch.where(gt_valid[:, None], iou, -1.0)
        matched_vals = iou.amax(dim=0)                              # (N,)
        matched_idx = torch.argmax(iou, dim=0).to(torch.int32)
        lq = None
        if allow_low_quality_matches:
            # anchors achieving a gt's maximum IoU become foreground
            highest_per_gt = iou.amax(dim=1, keepdim=True)          # (G, 1)
            is_best = ((iou == highest_per_gt)
                       & gt_valid[:, None] & (highest_per_gt > 0))
            lq = is_best.any(dim=0)

    match_labels = _threshold_labels(matched_vals, thresholds, labels)
    if lq is not None:
        match_labels = torch.where(lq, labels[-1], match_labels)

    # with no valid gt everything is background
    match_labels = torch.where(gt_valid.any(), match_labels, labels[0])
    return matched_idx, match_labels


def topk_matcher(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's TopKMatcher: besides the threshold rule, the k
    highest-IoU anchors of each gt are foreground. Among anchors tied at the
    k-th IoU the lowest indices are taken, as ``jax.lax.top_k`` takes them
    (a stable descending sort; ``torch.topk`` promises no order)."""
    iou = box_ops.pairwise_iou(gt_boxes, anchors)
    iou = torch.where(gt_valid[:, None], iou, -1.0)

    matched_vals = iou.amax(dim=0)
    matched_idx = torch.argmax(iou, dim=0).to(torch.int32)
    match_labels = _threshold_labels(matched_vals, thresholds, labels)

    k = min(k, iou.shape[1])
    topk_val, topk_idx = (t[:, :k] for t in torch.sort(
        iou, dim=1, descending=True, stable=True))                  # (G, k)
    valid_top = (topk_val > 0) & gt_valid[:, None]
    fg = torch.zeros(iou.shape[1], dtype=torch.bool, device=iou.device)
    fg[topk_idx[valid_top]] = True
    match_labels = torch.where(fg, labels[-1], match_labels)

    match_labels = torch.where(gt_valid.any(), match_labels, labels[0])
    return matched_idx, match_labels


def build_matcher(cfg):
    """``match(anchors, gt_boxes, gt_valid)`` per cfg.MODEL.RPN.MATCHER."""
    mtype = cfg.MODEL.RPN.MATCHER.TYPE
    thresholds = cfg.MODEL.RPN.IOU_THRESHOLDS
    labels = cfg.MODEL.RPN.IOU_LABELS
    if mtype == "Origin":
        def match(anchors, gt_boxes, gt_valid):
            return iou_matcher(anchors, gt_boxes, gt_valid, thresholds, labels)
        return match
    if mtype == "TopK":
        k = cfg.MODEL.RPN.MATCHER.TOPK

        def match(anchors, gt_boxes, gt_valid):
            return topk_matcher(anchors, gt_boxes, gt_valid, thresholds, labels, k)
        return match
    raise ValueError(f"Unknown matcher type {mtype!r}")
