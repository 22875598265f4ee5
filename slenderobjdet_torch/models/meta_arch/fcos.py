"""FCOS (counterpart of ``slenderobjdet_tpu/models/meta_arch/fcos.py``:
``FCOSHead``, ``FCOSModule``, ``fcos_assign_single`` batched as
``fcos_assign``, ``compute_centerness_targets``, ``FCOS.loss``,
``FCOS.predict``, ``_fcos_level_candidates``, ``FCOSTopK`` and ``FCOSV3``;
``use_centerness=False`` is the no-centerness ablation ``FCOSNCRetinaNet``
and ``with_anchor`` the diagnosis variant ``FCOSWithAnchor``).

Training is fixed-shape as in the JAX package: padded gt boxes with a
validity mask, every location assigned to the smallest-area gt box that
contains it within its level's size range, focal classification loss, IoU
loss weighted by the centerness target and centerness BCE, each normalised
by a sum over the whole batch. With ``topk_per_gt`` (``FCOSTopK``) only the
k highest-centerness positives of each gt feed the regression loss
(``topk_per_gt_gate``). With ``mask_center_sampling`` (``FCOSV3``) a
positive location whose polygon-rendered centre score (``batch
["center_mask"]``, read at the location's truncated pixel) is at most
``mask_thresh`` becomes background (``mask_center_gate``).

Inference is fixed-shape too: per-level threshold and pair top-k of
``PRE_NMS_TOP_N`` candidates, ltrb decoding, then class-aware greedy NMS
keeping ``TEST.DETECTIONS_PER_IMAGE`` slots with a validity mask. On CUDA
tensors the NMS always runs the hand-written kernel
(``ops/nms.py:cuda_batched_nms``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import iou_loss_ltrb, optax_sigmoid_ce, sigmoid_focal_loss
from ...ops.nms import cuda_batched_nms
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_normalizer
from ...structures import boxes as box_ops
from ..anchors import fcos_locations
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, DFConv2d, GroupNorm32, Scale,
                      init_detector_weights, prior_bias,
                      uses_batch_statistics)


class FCOSHead(nn.Module):
    """Shared 4-conv GroupNorm cls/bbox towers, per-level ``Scale`` on the
    bbox prediction, exp() decoding (the NORM_REG_TARGETS=False path).
    ``with_ctr=False`` leaves the centerness conv out; ``use_dcn_in_tower``
    makes the last conv of each tower a ``DFConv2d``, modulated with
    ``use_dcn_v2``."""

    def __init__(self, in_channels: int, num_classes: int, num_levels: int,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 centerness_on_reg: bool = False,
                 norm_reg_targets: bool = False,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 with_ctr: bool = True, use_dcn_in_tower: bool = False,
                 use_dcn_v2: bool = True):
        super().__init__()
        c = in_channels
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        self.centerness_on_reg = centerness_on_reg
        self.norm_reg_targets = norm_reg_targets
        self.strides = tuple(strides)
        self.with_ctr = with_ctr
        for prefix in ("cls", "bbox"):
            for i in range(num_convs):
                deform = use_dcn_in_tower and i == num_convs - 1
                self.add_module(f"{prefix}_tower{i}",
                                DFConv2d(c, c, modulated=use_dcn_v2) if deform
                                else Conv2d(c, c, 3, padding=1))
                self.add_module(f"{prefix}_tower_gn{i}", GroupNorm32(c))
        self.cls_logits = Conv2d(c, num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(c, 4, 3, padding=1)
        if with_ctr:
            self.centerness = Conv2d(c, 1, 3, padding=1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def _tower(self, prefix, x):
        for i in range(self.num_convs):
            x = getattr(self, f"{prefix}_tower{i}")(x)
            x = F.relu(getattr(self, f"{prefix}_tower_gn{i}")(x))
        return x

    def forward(self, feats: List[torch.Tensor], train: bool = False):
        """feats: list of (B, C, H_l, W_l). Returns per-level lists of
        (B, H*W, num_classes) logits, (B, H*W, 4) reg and (B, H*W)
        centerness (None in place of the list without the centerness conv),
        float32, in row-major (h, w) order. With NORM_REG_TARGETS
        the regression is in stride units when ``train`` (the loss divides
        its targets by the stride) and in pixels otherwise."""
        logits_all, reg_all, ctr_all = [], [], []
        for lvl, x in enumerate(feats):
            b, _, h, w = x.shape
            ct = self._tower("cls", x)
            bt = self._tower("bbox", x)
            logits = self.cls_logits(ct).float()
            reg = getattr(self, f"scale{lvl}")(self.bbox_pred(bt).float())
            if self.norm_reg_targets:
                reg = F.relu(reg)
                if not train:
                    reg = reg * self.strides[lvl]
            else:
                # clamped exponent, as the JAX head: 2^13 px is beyond any box
                reg = torch.exp(torch.clamp(reg, -12.0, 9.0))

            def flat(t):
                return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

            logits_all.append(flat(logits))
            reg_all.append(flat(reg))
            if self.with_ctr:
                ctr = self.centerness(bt if self.centerness_on_reg else ct)
                ctr_all.append(flat(ctr.float())[..., 0])
        return logits_all, reg_all, (ctr_all if self.with_ctr else None)


INF = 1e8

# object size-of-interest ranges per FPN level (reference fcos.py:330-336)
SIZES_OF_INTEREST = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def sizes_of_interest(counts: Sequence[int]) -> np.ndarray:
    """(sum counts, 2) float32: each location's level range."""
    return np.concatenate([
        np.broadcast_to(np.array(SIZES_OF_INTEREST[i], np.float32), (c, 2))
        for i, c in enumerate(counts)], axis=0)


def fcos_assign(locations, soi, gt_boxes, gt_classes, gt_valid,
                num_classes: int):
    """FCOS target assignment over a batch (``fcos_assign_single`` of the
    JAX package, one image per row).

    locations (L, 2) xy, soi (L, 2), gt_boxes (B, G, 4) XYXY, gt_classes
    (B, G), gt_valid (B, G) bool. Returns labels (B, L) int64
    (``num_classes`` = background), reg_targets (B, L, 4) ltrb and the
    matched gt index (B, L).

    The l/t/r/b planes are separate (B, L, G) tensors and the matched pair's
    ltrb is recomputed after the argmin, as in the JAX package, whose fp op
    order the tests pin; ``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does, so tied areas pick the lowest gt index."""
    xs = locations[None, :, 0:1]                     # (1, L, 1)
    ys = locations[None, :, 1:2]
    l = xs - gt_boxes[:, None, :, 0]                 # (B, L, G) each
    t = ys - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - xs
    b = gt_boxes[:, None, :, 3] - ys
    is_in_box = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 0
    max_reg = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
    cared = (max_reg >= soi[None, :, 0:1]) & (max_reg <= soi[None, :, 1:2])
    areas = box_ops.area(gt_boxes)                   # (B, G)
    loc2gt = torch.where(is_in_box & cared & gt_valid[:, None, :],
                         areas[:, None, :], INF)
    min_area = loc2gt.amin(dim=2)
    gt_ind = torch.argmin(loc2gt, dim=2)             # (B, L)

    matched = torch.gather(gt_boxes, 1, gt_ind[..., None].expand(-1, -1, 4))
    loc_x, loc_y = locations[None, :, 0], locations[None, :, 1]
    reg_targets = torch.stack(
        [loc_x - matched[..., 0], loc_y - matched[..., 1],
         matched[..., 2] - loc_x, matched[..., 3] - loc_y], dim=-1)
    labels = torch.where(min_area >= INF, num_classes,
                         torch.gather(gt_classes.long(), 1, gt_ind))
    return labels, reg_targets, gt_ind


def compute_centerness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b))), (..., 4) -> (...)."""
    lr = reg_targets[..., 0::2]
    tb = reg_targets[..., 1::2]
    eps = 1e-12
    c = (lr.amin(-1) / torch.clamp(lr.amax(-1), min=eps)) * (
        tb.amin(-1) / torch.clamp(tb.amax(-1), min=eps))
    return torch.sqrt(torch.clamp(c, min=0.0))


def topk_per_gt_gate(ctr_targets, pos, gt_inds, num_gt: int, k: int):
    """The regression positives (B, L) bool of the top-k-per-gt gate: a
    positive location passes when its centerness target is at least the k-th
    largest among its gt's positives.

    ctr_targets (B, L), pos (B, L) bool, gt_inds (B, L) the matched gt index.
    As in the JAX package, a gt with fewer than k positives has a k-th value
    of -inf, which the ``isfinite`` guard turns into +inf, so no location of
    that gt passes. Only the k-th value is read, so the order ``torch.topk``
    gives tied values does not matter."""
    per_gt = (gt_inds[..., None] == torch.arange(num_gt, device=gt_inds.device)) \
        & pos[..., None]                                          # (B, L, G)
    scores = torch.where(per_gt, ctr_targets[..., None], -torch.inf)
    kth = torch.topk(scores.transpose(1, 2), k, dim=-1).values[..., -1]   # (B, G)
    kth = torch.where(torch.isfinite(kth), kth, torch.inf)
    return ((scores >= kth[:, None, :]) & per_gt).any(dim=-1)


def mask_center_gate(labels, locations, center_mask, num_classes: int,
                     thresh: float):
    """FCOSV3's gate (JAX ``fcos.py:363-373``): labels (B, L) with every
    positive whose center score is at most ``thresh`` set to background.
    The score of a location is ``center_mask`` (B, H, W) at its (x, y)
    truncated toward zero (``astype(int32)``) and clipped to the map."""
    ix = torch.clamp(locations[:, 0].int(), 0, center_mask.shape[2] - 1).long()
    iy = torch.clamp(locations[:, 1].int(), 0, center_mask.shape[1] - 1).long()
    scores_at = center_mask[:, iy, ix]                              # (B, L)
    return torch.where((labels < num_classes) & (scores_at <= thresh),
                       num_classes, labels)


class FCOSModule(nn.Module):
    """Backbone + FPN + FCOS head over uint8 NHWC images; the image is
    normalised in float32 and then cast to the compute dtype."""

    def __init__(self, backbone: nn.Module, head: FCOSHead,
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

    def forward(self, images: torch.Tensor, train: bool = False):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        # NHWC -> NCHW view, which is channels_last memory
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = self.backbone(x)
        return self.head([feats[f] for f in self.in_features], train=train)


def _fcos_level_candidates(logits, reg, ctr, locations, pre_nms_thresh,
                           pre_nms_top_n):
    """Fixed-shape per-level candidate selection.

    logits (B, L, C); reg (B, L, 4); ctr (B, L) or None (ranking by the raw
    class score); locations (L, 2). Returns boxes (B, K, 4), scores (B, K),
    classes (B, K) int32, valid (B, K) bool and each candidate's source
    location (B, K, 2), with K = min(pre_nms_top_n, L*C)."""
    scores = torch.sigmoid(logits.float())                        # (B, L, C)
    candidate = scores > pre_nms_thresh
    if ctr is not None:
        ranked = scores * torch.sigmoid(ctr.float())[:, :, None]  # cls * ctr
    else:
        ranked = scores
    rank = torch.where(candidate, ranked, 0.0)

    top_scores, loc_idx, cls_idx = pair_top_k(rank, pre_nms_top_n)
    valid = top_scores > 0.0

    sel_reg = torch.gather(reg, 1, loc_idx[..., None].expand(-1, -1, 4))
    sel_loc = locations[loc_idx]                                  # (B, K, 2)
    boxes = box_ops.decode_ltrb(sel_loc, sel_reg)
    return boxes, torch.sqrt(top_scores), cls_idx, valid, sel_loc


class FCOS(FCOSModule):
    """Config-driven FCOS detector: the network plus the fixed-shape
    predict path."""

    # the regression positives a gt (FCOSTopK sets 5); FCOSV3's mask-based
    # centre sampling and its threshold
    topk_per_gt = None
    mask_center_sampling = False
    mask_thresh = 0.2

    def __init__(self, cfg, use_centerness: bool = True,
                 with_anchor: bool = False):
        """``use_centerness=False``: no centerness branch, the regression loss
        normalised by ``num_pos`` instead of the centerness sum, inference
        ranked by the raw class score. ``with_anchor``: ``predict`` also
        returns each detection's source location as a degenerate (x, y, x, y)
        box under ``"anchors"``."""
        f = cfg.MODEL.FCOS
        if cfg.TPU.PACK_HEAD_LEVELS:
            raise NotImplementedError("TPU.PACK_HEAD_LEVELS is not ported")
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        head = FCOSHead(
            in_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            num_classes=f.NUM_CLASSES,
            num_levels=len(f.IN_FEATURES),
            num_convs=f.NUM_CONVS,
            prior_prob=f.PRIOR_PROB,
            centerness_on_reg=f.CENTERNESS_ON_REG,
            norm_reg_targets=f.NORM_REG_TARGETS,
            strides=tuple(f.FPN_STRIDES),
            with_ctr=use_centerness,
            use_dcn_in_tower=f.USE_DCN_IN_TOWER,
            use_dcn_v2=f.USE_DCN_V2,
        )
        super().__init__(backbone, head, f.IN_FEATURES, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.use_centerness = use_centerness
        self.with_anchor = with_anchor
        self.strides = list(f.FPN_STRIDES)
        self.num_classes = f.NUM_CLASSES
        self.focal_alpha = f.FOCAL_LOSS_ALPHA
        self.focal_gamma = f.FOCAL_LOSS_GAMMA
        self.iou_loss_type = f.IOU_LOSS_TYPE
        self.norm_reg_targets = f.NORM_REG_TARGETS
        self.pre_nms_thresh = f.INFERENCE_TH
        self.pre_nms_top_n = f.PRE_NMS_TOP_N
        self.nms_thresh = f.NMS_TH
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.int8_predict = cfg.TPU.INT8_PREDICT

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` and the cls bias at the focal prior."""
        init_detector_weights(self, generator)
        self.head.cls_logits.bias.fill_(prior_bias(self.head.prior_prob))

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4) XYXY,
        "gt_classes": (B, G) int, "gt_valid": (B, G) bool} and, for
        ``mask_center_sampling``, "center_mask" (B, H, W) float, as numpy
        arrays or tensors. Returns the total loss and {"cls_loss",
        "reg_loss", "centerness_loss" (with the centerness branch),
        "num_pos"}; every normaliser is a count over the global batch,
        summed over the processes (``parallel.multihost.global_normalizer``)."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        locations_np, counts = fcos_locations(tuple(images.shape[1:3]),
                                              self.strides)
        locations = torch.as_tensor(locations_np, device=dev)
        soi = torch.as_tensor(sizes_of_interest(counts), device=dev)

        logits_l, reg_l, ctr_l = self(images, train=True)
        logits = torch.cat(logits_l, dim=1)          # (B, L, C)
        reg = torch.cat(reg_l, dim=1)                # (B, L, 4)
        ctr = None if ctr_l is None else torch.cat(ctr_l, dim=1)   # (B, L)

        gt_boxes = torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev)
        labels, reg_targets, gt_inds = fcos_assign(
            locations, soi, gt_boxes,
            torch.as_tensor(batch["gt_classes"], device=dev),
            torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev),
            self.num_classes)
        if self.mask_center_sampling and "center_mask" in batch:
            labels = mask_center_gate(
                labels, locations,
                torch.as_tensor(batch["center_mask"], dtype=torch.float32, device=dev),
                self.num_classes, self.mask_thresh)
        if self.norm_reg_targets:
            stride_per_loc = torch.as_tensor(np.concatenate([
                np.full((c,), s, np.float32)
                for c, s in zip(counts, self.strides)]), device=dev)
            reg_targets = reg_targets / stride_per_loc[None, :, None]

        pos = labels < self.num_classes              # (B, L)
        num_pos, pos_share = global_normalizer(pos.sum().float(), 1.0)

        # focal classification loss over all locations; background rows of
        # the one-hot are zero
        onehot = F.one_hot(labels, self.num_classes + 1)[..., :-1].float()
        cls_loss = sigmoid_focal_loss(logits, onehot, self.focal_alpha,
                                      self.focal_gamma).sum() / pos_share

        # Centerness-weighted IoU loss on positives. Non-positive rows carry
        # garbage targets (possibly negative ltrb, the log of a negative in
        # the IoU loss): a safe constant goes in BEFORE the loss, since a
        # where after it does not stop NaN gradients from the untaken branch.
        safe_targets = torch.where(pos[..., None], reg_targets, 1.0)
        ctr_targets = compute_centerness_targets(safe_targets)
        ctr_targets = torch.where(pos, ctr_targets, 0.0)

        reg_pos = pos
        if self.topk_per_gt:
            reg_pos = topk_per_gt_gate(ctr_targets, pos, gt_inds, gt_boxes.shape[1],
                                       self.topk_per_gt)

        reg_losses = iou_loss_ltrb(reg, safe_targets, self.iou_loss_type)
        if not self.use_centerness:
            # unweighted IoU loss over num_pos
            reg_loss = torch.where(reg_pos, reg_losses, 0.0).sum() / pos_share
            return cls_loss + reg_loss, {"cls_loss": cls_loss,
                                         "reg_loss": reg_loss,
                                         "num_pos": num_pos}
        _, ctr_share = global_normalizer(
            torch.where(reg_pos, ctr_targets, 0.0).sum(), 1e-6)
        reg_loss = torch.where(reg_pos, reg_losses * ctr_targets,
                               0.0).sum() / ctr_share
        ctr_loss = torch.where(pos, optax_sigmoid_ce(ctr, ctr_targets),
                               0.0).sum() / pos_share
        total = cls_loss + reg_loss + ctr_loss
        return total, {"cls_loss": cls_loss, "reg_loss": reg_loss,
                       "centerness_loss": ctr_loss, "num_pos": num_pos}

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,),
        "orig_size": (B, 2)} as numpy arrays or tensors. Returns fixed-shape
        detections in original image coordinates: boxes (B, D, 4), scores
        (B, D), classes (B, D) int32, valid (B, D) bool and, ``with_anchor``,
        anchors (B, D, 4)."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            logits_l, reg_l, ctr_l = self(images)
        return self.postprocess(
            logits_l, reg_l, ctr_l, tuple(images.shape[1:3]),
            torch.as_tensor(batch["scale"], device=dev),
            torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, reg_l, ctr_l, image_hw):
        """The NMS's input from the head's per-level outputs: per level the
        threshold and the top ``pre_nms_top_n`` pairs, decoded, concatenated:
        boxes (B, N, 4), scores, classes, valid and source locations."""
        locations_np, counts = fcos_locations(image_hw, self.strides)
        dev = logits_l[0].device
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cands = []
        for lvl in range(len(counts)):
            locs = torch.as_tensor(
                locations_np[offsets[lvl]: offsets[lvl + 1]], device=dev)
            cands.append(_fcos_level_candidates(
                logits_l[lvl], reg_l[lvl],
                None if ctr_l is None else ctr_l[lvl], locs,
                self.pre_nms_thresh, self.pre_nms_top_n))
        return tuple(torch.cat(t, dim=1) for t in zip(*cands))

    def postprocess(self, logits_l, reg_l, ctr_l, image_hw,
                    scale, orig_size) -> Dict[str, torch.Tensor]:
        """Candidates, NMS and rescaling from the head's per-level outputs."""
        boxes, scores, classes, valid, locs = self.candidates(logits_l, reg_l, ctr_l,
                                                              image_hw)

        keep_idx, keep_valid = cuda_batched_nms(
            boxes, scores, classes, self.nms_thresh, self.max_dets,
            valid=valid)
        keep = keep_idx.long()
        scale = scale.float()[:, None, None]
        orig = orig_size.float()
        kb = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)) / scale
        kb = box_ops.clip(kb, orig[:, 0:1], orig[:, 1:2])
        out = {
            "boxes": kb,
            "scores": torch.gather(scores, 1, keep),
            "classes": torch.gather(classes, 1, keep),
            "valid": keep_valid,
        }
        if self.with_anchor:
            pts = torch.gather(locs, 1, keep[..., None].expand(-1, -1, 2)) / scale
            out["anchors"] = torch.cat([pts, pts], dim=-1)
        return out


class FCOSTopK(FCOS):
    """FCOS whose regression loss takes only the 5 highest-centerness
    positives of each gt; the classification and centerness losses keep
    every positive."""

    topk_per_gt = 5


class FCOSV3(FCOS):
    """FCOS with mask-based center sampling (reference fcosv3.py:55-343):
    only locations where the polygon-rendered center-score map exceeds 0.2
    stay positive. Needs cfg.NEED_MASKS, so that the loader gives
    ``center_mask`` (``data/mapper.py``, ``structures/borders.py``)."""

    mask_center_sampling = True
