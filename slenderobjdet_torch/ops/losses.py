"""Detection losses, reduction-free (counterpart of
``slenderobjdet_tpu/ops/losses.py``): each returns per-element or per-row
losses and the caller applies masks and normalisers. The fp op order is the
JAX package's, so the CPU tests match it to float32 rounding."""

from __future__ import annotations

import torch


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25,
                       gamma: float = 2.0):
    """Per-element focal loss; targets in {0, 1} (float)."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def optax_sigmoid_ce(logits, labels):
    """Numerically stable sigmoid binary cross-entropy (elementwise), as
    optax's ``sigmoid_binary_cross_entropy``:
    ``max(x, 0) - x * z + log(1 + exp(-|x|))``."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def smooth_l1_loss(pred, target, beta: float):
    """Per-element smooth-L1 (Huber) loss; beta <= 0 degenerates to L1."""
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _ltrb_iou_terms(pred, target):
    """pred/target (..., 4) as (l, t, r, b) distances from one location."""
    pred_l, pred_t, pred_r, pred_b = pred.unbind(-1)
    tgt_l, tgt_t, tgt_r, tgt_b = target.unbind(-1)

    tgt_area = (tgt_l + tgt_r) * (tgt_t + tgt_b)
    pred_area = (pred_l + pred_r) * (pred_t + pred_b)

    w_inter = torch.minimum(pred_l, tgt_l) + torch.minimum(pred_r, tgt_r)
    h_inter = torch.minimum(pred_t, tgt_t) + torch.minimum(pred_b, tgt_b)
    w_inter = torch.clamp(w_inter, min=0.0)
    h_inter = torch.clamp(h_inter, min=0.0)

    g_w = torch.maximum(pred_l, tgt_l) + torch.maximum(pred_r, tgt_r)
    g_h = torch.maximum(pred_t, tgt_t) + torch.maximum(pred_b, tgt_b)

    inter = w_inter * h_inter
    union = tgt_area + pred_area - inter
    enclose = g_w * g_h
    return inter, union, enclose


def iou_loss_ltrb(pred, target, loss_type: str = "iou"):
    """IoU loss on (l, t, r, b) regression targets; per-row loss (...,)."""
    inter, union, enclose = _ltrb_iou_terms(pred, target)
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        return -torch.log(ious)
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        gious = ious - (enclose - union) / torch.clamp(enclose, min=1e-7)
        return 1.0 - gious
    raise ValueError(f"Unknown iou loss type {loss_type!r}")


def iou_loss_boxes(pred, target, loss_type: str = "giou", eps: float = 1e-7):
    """IoU loss on XYXY boxes; per-row loss (...,)."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)

    pred_area = torch.clamp(px2 - px1, min=0) * torch.clamp(py2 - py1, min=0)
    tgt_area = torch.clamp(tx2 - tx1, min=0) * torch.clamp(ty2 - ty1, min=0)

    iw = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1), min=0)
    ih = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1), min=0)
    inter = iw * ih
    union = pred_area + tgt_area - inter
    ious = inter / torch.clamp(union, min=eps)

    if loss_type == "iou":
        return -torch.log(torch.clamp(ious, min=eps))
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        ew = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
        eh = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
        enclose = ew * eh
        gious = ious - (enclose - union) / torch.clamp(enclose, min=eps)
        return 1.0 - gious
    raise ValueError(f"Unknown iou loss type {loss_type!r}")
