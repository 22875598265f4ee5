"""FCOSAnchor: the FCOS grid regressing offsets from per-location anchors
(counterpart of ``slenderobjdet_tpu/models/meta_arch/fcos_anchor.py``:
``FCOSAnchorHead``, ``anchor_iou_terms`` and ``FCOSAnchor``).

- FCOS's in-box and size-of-interest assignment per location; the A
  anchors of a location (``MODEL.ANCHOR_GENERATOR``) share its targets.
- The head's ltrb prediction is added to the anchor's ltrb offsets from
  the location. Each anchor's IoU loss gives, through a per-location
  softmax of 1 / loss, the target of a shape-classification branch (no
  gradient flows into the target); the regression loss is weighted by
  centerness x the softmax of the shape logits.
- Inference: score = sigmoid(cls) x sigmoid(centerness x shape logit), the
  pair top-k, the square root as the score, the threshold at
  ``INFERENCE_TH`` squared, one class-aware NMS over all levels, on CUDA
  tensors the hand-written kernel (``ops/nms.py:cuda_batched_nms``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import optax_sigmoid_ce, sigmoid_focal_loss
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_normalizer, global_quotient
from ..anchors import AnchorGeneratorSpec, fcos_locations
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, GroupNorm32, Scale, init_detector_weights, prior_bias,
                      uses_batch_statistics)
from .fcos import compute_centerness_targets, fcos_assign, sizes_of_interest
from .reppoints import RepPointsModule, nms_detections


class FCOSAnchorHead(nn.Module):
    """GroupNorm cls and bbox towers of ``num_convs`` 3x3 convs, and 3x3
    ``cls_logits`` (A x classes), ``bbox_pred`` (A x 4, times the level's
    ``Scale``), ``centerness`` (1, on the cls tower) and ``shape_cls`` (A, on
    the bbox tower). ``forward`` returns per-level lists of
    (B, H*W*A, classes), (B, H*W*A, 4), (B, H*W) and (B, H*W*A), float32,
    anchor-minor within a cell."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int = 4, prior_prob: float = 0.01, num_levels: int = 5):
        super().__init__()
        c = in_channels
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        for prefix in ("cls", "bbox"):
            for i in range(num_convs):
                self.add_module(f"{prefix}_tower{i}", Conv2d(c, c, 3, padding=1))
                self.add_module(f"{prefix}_gn{i}", GroupNorm32(c))
        A = num_anchors
        self.cls_logits = Conv2d(c, A * num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(c, A * 4, 3, padding=1)
        self.centerness = Conv2d(c, 1, 3, padding=1)
        self.shape_cls = Conv2d(c, A, 3, padding=1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def _tower(self, prefix, x):
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"{prefix}_gn{i}")(getattr(self, f"{prefix}_tower{i}")(x)))
        return x

    def forward(self, feats: List[torch.Tensor]):
        out_cls, out_reg, out_ctr, out_shape = [], [], [], []
        for lvl, x in enumerate(feats):
            b, _, h, w = x.shape
            n = h * w * self.num_anchors
            ct, bt = self._tower("cls", x), self._tower("bbox", x)

            def flat(t, *shape):
                return t.float().permute(0, 2, 3, 1).reshape(b, *shape)

            out_cls.append(flat(self.cls_logits(ct), n, self.num_classes))
            reg = getattr(self, f"scale{lvl}")(self.bbox_pred(bt).float())
            out_reg.append(flat(reg, n, 4))
            out_ctr.append(flat(self.centerness(ct), h * w))
            out_shape.append(flat(self.shape_cls(bt), n))
        return out_cls, out_reg, out_ctr, out_shape


def anchor_iou_terms(pred, target):
    """Per-row (losses, ious) of ltrb pairs: -log of the IoU with 1 added to
    the intersection and the union, the IoU floored at 1e-6."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    t_area = (tl + tr) * (tt + tb)
    p_area = (pl + pr) * (pt + pb)
    wi = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    hi = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    inter = torch.clamp(wi, min=0) * torch.clamp(hi, min=0)
    union = t_area + p_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    return -torch.log(torch.clamp(ious, min=1e-6)), ious


def _row_softmax(x, pos_a, num_anchors):
    """Softmax over each location's A anchors where the location is
    positive, 0 elsewhere. The JAX function fills the other rows with -inf
    and masks the softmax's NaN; a location's anchors are all positive or
    all not, so a 0 fill gives the same values and keeps NaN out of the
    backward."""
    sm = torch.softmax(torch.where(pos_a, x, 0.0).reshape(-1, num_anchors), dim=-1)
    return torch.where(pos_a, sm.reshape(pos_a.shape), 0.0)


class FCOSAnchor(RepPointsModule):
    """Config-driven FCOSAnchor under the ``MODEL.FCOS`` keys, its anchors
    from ``MODEL.ANCHOR_GENERATOR``."""

    def __init__(self, cfg):
        if cfg.TPU.PACK_HEAD_LEVELS:
            raise NotImplementedError("TPU.PACK_HEAD_LEVELS is not ported")
        f = cfg.MODEL.FCOS
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        strides = list(f.FPN_STRIDES)
        anchor_spec = AnchorGeneratorSpec(cfg, strides)
        num_anchors = anchor_spec.num_cell_anchors[0]
        assert all(a == num_anchors for a in anchor_spec.num_cell_anchors)
        head = FCOSAnchorHead(cfg.MODEL.FPN.OUT_CHANNELS, f.NUM_CLASSES, num_anchors,
                              num_convs=f.NUM_CONVS, prior_prob=f.PRIOR_PROB,
                              num_levels=len(strides))
        super().__init__(build_backbone(cfg), head, f.IN_FEATURES, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.strides = strides
        self.anchor_spec = anchor_spec
        self.num_anchors = num_anchors
        self.num_classes = f.NUM_CLASSES
        self.focal_alpha = f.FOCAL_LOSS_ALPHA
        self.focal_gamma = f.FOCAL_LOSS_GAMMA
        self.pre_nms_thresh = f.INFERENCE_TH
        self.pre_nms_top_n = f.PRE_NMS_TOP_N
        self.nms_thresh = f.NMS_TH
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` and the cls bias at the focal prior."""
        init_detector_weights(self, generator)
        self.head.cls_logits.bias.fill_(prior_bias(self.head.prior_prob))

    def _geometry(self, image_hw):
        """Locations (L, 2), level counts, each anchor's ltrb offsets from its
        location (L*A, 4) and the sizes of interest (L, 2), numpy."""
        locations, counts = fcos_locations(image_hw, self.strides)
        anchors, _ = self.anchor_spec.anchors(image_hw)
        locs_exp = np.repeat(locations, self.num_anchors, axis=0)
        anchor_off = np.concatenate([locs_exp - anchors[:, :2], anchors[:, 2:] - locs_exp],
                                    axis=1).astype(np.float32)
        return locations, counts, anchor_off, sizes_of_interest(counts)

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image", "gt_boxes", "gt_classes", "gt_valid"} as for
        ``FCOS.loss``. Returns the total loss and {"cls_loss", "reg_loss",
        "centerness_loss", "shape_loss", "num_pos"}."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        locations, counts, anchor_off, soi = self._geometry(tuple(images.shape[1:3]))
        anchor_off = torch.as_tensor(anchor_off, device=dev)
        A = self.num_anchors
        cls_l, reg_l, ctr_l, shape_l = self(images)
        logits = torch.cat(cls_l, dim=1)                 # (B, L*A, C)
        regs = torch.cat(reg_l, dim=1)                   # (B, L*A, 4)
        ctr = torch.cat(ctr_l, dim=1)                    # (B, L)
        shape_logits = torch.cat(shape_l, dim=1)         # (B, L*A)

        with torch.no_grad():
            labels, reg_targets, _ = fcos_assign(
                torch.as_tensor(locations, device=dev), torch.as_tensor(soi, device=dev),
                torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
                torch.as_tensor(batch["gt_classes"], device=dev),
                torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev),
                self.num_classes)
        pos = labels < self.num_classes                  # (B, L)
        pos_a = pos.repeat_interleave(A, dim=1)          # (B, L*A)
        labels_a = labels.repeat_interleave(A, dim=1)
        targets_a = reg_targets.repeat_interleave(A, dim=1)
        num_pos, pos_share = global_normalizer(pos.sum().float(), 1.0)
        _, pos_a_share = global_normalizer(pos_a.sum().float(), 1.0)

        onehot = (labels_a[..., None] == torch.arange(self.num_classes, device=dev)).float()
        cls_loss = sigmoid_focal_loss(logits, onehot, self.focal_alpha,
                                      self.focal_gamma).sum() / pos_a_share

        # a safe target on non-positive rows BEFORE the losses
        safe_t = torch.where(pos_a[..., None], targets_a, 1.0)
        losses, _ = anchor_iou_terms(regs + anchor_off[None], safe_t)      # (B, L*A)
        norm_losses = _row_softmax(1.0 / torch.clamp(losses, min=1e-3), pos_a, A).detach()

        ctr_targets = torch.where(pos, compute_centerness_targets(
            torch.where(pos[..., None], reg_targets, 1.0)), 0.0)
        weights = torch.where(pos_a, ctr_targets.repeat_interleave(A, dim=1)
                              * _row_softmax(shape_logits, pos_a, A), 0.0)
        # the weights' sum carries the shape logits' gradient, as in JAX
        reg_loss = global_quotient(torch.where(pos_a, losses * weights, 0.0).sum(),
                                   weights.sum(), 1e-6)
        ctr_loss = torch.where(pos, optax_sigmoid_ce(ctr, ctr_targets), 0.0).sum() / pos_share
        shape_loss = torch.where(pos_a, optax_sigmoid_ce(shape_logits, norm_losses),
                                 0.0).sum() / pos_a_share
        total = cls_loss + reg_loss + ctr_loss + shape_loss
        return total, {"cls_loss": cls_loss, "reg_loss": reg_loss,
                       "centerness_loss": ctr_loss, "shape_loss": shape_loss,
                       "num_pos": num_pos}

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image", "scale", "orig_size"} as for ``FCOS.predict``.
        Returns boxes (B, D, 4), scores (B, D), classes (B, D) int32 and
        valid (B, D) bool in original image coordinates."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            outputs = self(images)
        return self.postprocess(outputs, tuple(images.shape[1:3]),
                                torch.as_tensor(batch["scale"], device=dev),
                                torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, outputs, image_hw):
        """The NMS's input: boxes (B, N, 4), scores (B, N), classes (B, N)
        int32 and valid (B, N) bool, with N the levels' top-k counts
        summed."""
        cls_l, reg_l, ctr_l, shape_l = outputs
        dev = cls_l[0].device
        A = self.num_anchors
        locations, counts, anchor_off, _ = self._geometry(image_hw)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cands = []
        for lvl in range(len(counts)):
            sl = slice(offsets[lvl] * A, offsets[lvl + 1] * A)
            locs = torch.as_tensor(np.repeat(locations[offsets[lvl]: offsets[lvl + 1]], A,
                                             axis=0), device=dev)
            a_off = torch.as_tensor(anchor_off[sl], device=dev)
            ctr = ctr_l[lvl].repeat_interleave(A, dim=1)
            scores = torch.sigmoid(cls_l[lvl].float())
            gate = torch.sigmoid((ctr * shape_l[lvl]).float())[..., None]
            top, loc_idx, cls_idx = pair_top_k(scores * gate, self.pre_nms_top_n)
            reg = torch.gather(reg_l[lvl], 1, loc_idx[..., None].expand(-1, -1, 4))
            off, loc = a_off[loc_idx], locs[loc_idx]
            boxes = torch.stack([loc[..., 0] - reg[..., 0] - off[..., 0],
                                 loc[..., 1] - reg[..., 1] - off[..., 1],
                                 loc[..., 0] + reg[..., 2] + off[..., 2],
                                 loc[..., 1] + reg[..., 3] + off[..., 3]], dim=-1)
            cands.append((boxes, torch.sqrt(torch.clamp(top, min=0.0)), cls_idx,
                          top > self.pre_nms_thresh ** 2))
        return tuple(torch.cat(t, dim=1) for t in zip(*cands))

    def postprocess(self, outputs, image_hw, scale, orig_size) -> Dict[str, torch.Tensor]:
        """Candidates, one NMS over all levels, rescaling and clipping."""
        return nms_detections(*self.candidates(outputs, image_hw), self.nms_thresh,
                              self.max_dets, scale, orig_size)
