"""The ablation chassis (counterpart of
``slenderobjdet_tpu/models/meta_arch/ablation.py``:
``compute_slender_centerness_targets``, ``MetaDeformConv``,
``MetaDualStageHead`` and ``AblationMetaArch``), which factors a one-stage
detector into box representation x feature adaption.

- ``MODEL.META_ARCH.NAME`` picks the representation: ``LRTBHead`` (FCOS's
  l, t, r, b at the half-stride locations, with centerness; ``LRTBTopkHead``
  regresses only the top 5 positives of each gt by centerness),
  ``PointSetHead`` (RepPoints' point sets on the grid without the half
  stride) or ``AnchorHead`` (RetinaNet's deltas on the anchors).
- ``MODEL.META_ARCH.FEAT_ADAPTION`` picks how the refine stage's features
  are adapted: ``Empty`` (a plain 3x3 conv), ``Unsupervised Offset`` (one
  1x1 conv of 18 offsets for both deformable convs), ``Split Unsup Offset``
  (one each) or ``Supervised Offset`` (the kernel's corner points pinned to
  the init prediction's box corners, the 7 others from a 14-channel 1x1
  conv).
- One head (``MetaDualStageHead``): cls and loc towers of ``STACK_CONVS``
  3x3 convs with GroupNorm, an init localisation branch, the two adapted
  convs, then the class logits, the refined localisation and, for LRTB,
  centerness. The deformable convs run in float32 whatever the compute
  dtype, as the JAX module does.
- Assignments, losses and inference reuse the FCOS, RepPoints and
  RetinaNet machinery. ``loss`` mutates nothing. ``predict`` ends in one
  class-aware NMS over every level's candidates, on CUDA tensors the
  hand-written kernel (``ops/nms.py:cuda_batched_nms``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import deform_apply, deform_sample_batched, kernel_base_offsets
from ...ops.losses import iou_loss_ltrb, optax_sigmoid_ce, sigmoid_focal_loss, smooth_l1_loss
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import (global_normalizer, global_sum, process_count,
                                   process_share)
from ...structures import boxes as box_ops
from ..anchors import AnchorGeneratorSpec, fcos_locations
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, DeformConvLayer, GroupNorm32, Scale, init_detector_weights,
                      prior_bias, uses_batch_statistics)
from ..matchers import iou_matcher
from .fcos import (_fcos_level_candidates, compute_centerness_targets, fcos_assign,
                   sizes_of_interest, topk_per_gt_gate)
from .reppoints import (RepPointsModule, nms_detections, point_grid, points2bbox,
                        rep_points_assign)
from .retinanet import _retina_level_candidates, retinanet_label_anchors

FEAT_ADAPTION_METHODS = ("Empty", "Unsupervised Offset", "Supervised Offset",
                         "Split Unsup Offset")
HEADS = ("LRTBHead", "LRTBTopkHead", "PointSetHead", "AnchorHead")


def compute_slender_centerness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """centerness ** (0.5 * min(w / h, h / w)) of (..., 4) ltrb -> (...)."""
    lr = reg_targets[..., 0::2]
    tb = reg_targets[..., 1::2]
    eps = 1e-12
    w = reg_targets[..., 0] + reg_targets[..., 2]
    h = reg_targets[..., 1] + reg_targets[..., 3]
    ratio = torch.minimum(w / torch.clamp(h, min=eps), h / torch.clamp(w, min=eps))
    c = (lr.amin(-1) / torch.clamp(lr.amax(-1), min=eps)) * (
        tb.amin(-1) / torch.clamp(tb.amax(-1), min=eps))
    return torch.pow(torch.clamp(c, min=0.0), 0.5 * ratio)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class MetaConv(nn.Module):
    """The ``Empty`` adaption's 3x3 conv, under the name ``conv`` that the
    JAX ``MetaDeformConv`` gives it; NCHW in and out."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, rel_offsets=None):
        return self.conv(x)


class MetaDeformConv(DeformConvLayer):
    """The offset adaptions' 3x3 deformable conv: a raw (9, Cin, Cout)
    ``weight`` and ``bias``. The offsets arrive in torch DCN's relative
    (dy, dx) x 9 convention, (B, H, W, 18), and are shifted by
    ``kernel_base_offsets(3)``; the features are sampled and multiplied in
    float32 whatever their dtype, and the result is cast back. NCHW in and
    out."""

    def sample(self, x: torch.Tensor, rel_offsets: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 9, Cin) float32 samples of x (B, Cin, H, W)."""
        b, _, h, w = x.shape
        base = torch.as_tensor(kernel_base_offsets(3), device=x.device)
        offsets = rel_offsets.reshape(b, h, w, 9, 2) + base
        return deform_sample_batched(_nhwc(x).float(), offsets.float())

    def apply_samples(self, samples: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The matmul on ``sample``'s output, cast to ``dtype``, NCHW."""
        return deform_apply(samples, self.weight, self.bias).to(dtype).permute(0, 3, 1, 2)

    def forward(self, x, rel_offsets=None):
        return self.apply_samples(self.sample(x, rel_offsets), x.dtype)


class MetaDualStageHead(nn.Module):
    """Shared cls/loc towers, the init branch, the feature adaption and the
    refine and classification outputs over NCHW levels. ``loc_dim`` is 4
    (ltrb or anchor deltas) or 2P (a point set); ``num_anchors`` outputs a
    cell. ``forward`` returns per-level lists of (B, H*W*A, num_classes)
    logits, (B, H*W*A) centerness (an empty list without it) and
    (B, H*W*A, loc_dim) init and refine localisation, float32, rows cell by
    cell in row-major (h, w) order and anchor-minor within a cell."""

    def __init__(self, in_channels: int, num_classes: int, loc_dim: int,
                 feat_adaption: str = "Empty", num_convs: int = 3,
                 feat_channels: int = 256, norm: str = "GN", gradient_mul: float = 0.1,
                 prior_prob: float = 0.01, res_refine: bool = False,
                 has_centerness: bool = False, centerness_on_loc: bool = False,
                 use_scales: bool = False, exp_decode: bool = False,
                 strides=(8, 16, 32, 64, 128), num_anchors: int = 1):
        super().__init__()
        if feat_adaption not in FEAT_ADAPTION_METHODS:
            raise ValueError(feat_adaption)
        c = feat_channels
        self.num_classes = num_classes
        self.loc_dim = loc_dim
        self.feat_adaption = feat_adaption
        self.num_convs = num_convs
        self.use_norm = norm == "GN"
        self.gradient_mul = gradient_mul
        self.prior_prob = prior_prob
        self.res_refine = res_refine
        self.has_centerness = has_centerness
        self.centerness_on_loc = centerness_on_loc
        self.use_scales = use_scales
        self.exp_decode = exp_decode
        self.strides = tuple(strides)
        self.num_anchors = num_anchors
        A = num_anchors
        for prefix in ("cls", "loc"):
            for i in range(num_convs):
                self.add_module(f"{prefix}_conv{i}",
                                Conv2d(in_channels if i == 0 else c, c, 3, padding=1))
                if self.use_norm:
                    self.add_module(f"{prefix}_gn{i}", GroupNorm32(c))
        self.loc_init_conv = Conv2d(c, c, 3, padding=1)
        self.loc_init_out = Conv2d(c, A * loc_dim, 1)
        deform = feat_adaption != "Empty"
        self.cls_conv = MetaDeformConv(c, c) if deform else MetaConv(c)
        self.loc_refine_conv = MetaDeformConv(c, c) if deform else MetaConv(c)
        if feat_adaption == "Unsupervised Offset":
            self.offset_conv = Conv2d(c, 18, 1)
        elif feat_adaption == "Split Unsup Offset":
            self.offset_conv_cls = Conv2d(c, 18, 1)
            self.offset_conv_loc = Conv2d(c, 18, 1)
        elif feat_adaption == "Supervised Offset":
            self.offset_conv_extend = Conv2d(c, 14, 1)
        self.cls_out = Conv2d(c, A * num_classes, 1)
        self.loc_refine_out = Conv2d(c, A * loc_dim, 1)
        if has_centerness:
            self.ctn_out = Conv2d(c, A, 1)
        if use_scales:
            for i in range(len(self.strides)):
                self.add_module(f"scale_init{i}", Scale())
                self.add_module(f"scale_refine{i}", Scale())

    # each stage of one level, in the order ``forward`` runs them
    def towers(self, x):
        """The cls and loc tower outputs of one level, NCHW."""
        cf, lf = x, x
        for i in range(self.num_convs):
            cf, lf = getattr(self, f"cls_conv{i}")(cf), getattr(self, f"loc_conv{i}")(lf)
            if self.use_norm:
                cf, lf = getattr(self, f"cls_gn{i}")(cf), getattr(self, f"loc_gn{i}")(lf)
            cf, lf = F.relu(cf), F.relu(lf)
        return cf, lf

    def _decode(self, raw, lvl, which):
        if self.use_scales:
            raw = getattr(self, f"scale_{which}{lvl}")(raw)
        return torch.exp(torch.clamp(raw, -12.0, 9.0)) if self.exp_decode else raw

    def init_loc(self, lf, lvl):
        """(B, H, W, A * loc_dim) float32 init localisation of level ``lvl``."""
        raw = _nhwc(self.loc_init_out(F.relu(self.loc_init_conv(lf)))).float()
        return self._decode(raw, lvl, "init")

    def _supervised_offsets(self, loc_init, extend, stride: float):
        """Kernel points (-1, -1) and (1, 1) follow the init prediction's box
        corners in (dy, dx) feature units through the ``gradient_mul``
        blend; the 7 middle points are learned (``extend``)."""
        b, h, w, _ = loc_init.shape
        g = self.gradient_mul
        gm = (1 - g) * loc_init.detach() + g * loc_init
        if self.exp_decode:
            lrtb = gm / stride
            tl = torch.stack([-lrtb[..., 1], -lrtb[..., 0]], -1)
            br = torch.stack([lrtb[..., 3], lrtb[..., 2]], -1)
        else:
            pts = gm.reshape(b, h, w, -1, 2)
            tl = pts[..., 0, :].flip(-1)
            br = pts[..., -1, :].flip(-1)
        base = torch.as_tensor(kernel_base_offsets(3), device=loc_init.device)
        return torch.cat([tl - base[0], extend, br - base[8]], dim=-1)

    def offsets(self, lf, loc_init, lvl):
        """The relative (B, H, W, 18) float32 offsets of the cls and loc
        deformable convs (None, None for ``Empty``)."""
        a = self.feat_adaption
        if a == "Empty":
            return None, None
        if a == "Unsupervised Offset":
            off = _nhwc(self.offset_conv(lf)).float()
            return off, off
        if a == "Split Unsup Offset":
            return (_nhwc(self.offset_conv_cls(lf)).float(),
                    _nhwc(self.offset_conv_loc(lf)).float())
        extend = _nhwc(self.offset_conv_extend(lf)).float()
        off = self._supervised_offsets(loc_init, extend, float(self.strides[lvl]))
        return off, off

    def adapt(self, cf, lf, offs):
        """The two adapted convs' outputs, NCHW in the towers' dtype."""
        return self.cls_conv(cf, offs[0]), self.loc_refine_conv(lf, offs[1])

    def outputs(self, cf_fa, lf_fa, loc_init, lvl):
        """(logits, centerness or None, refine) of one level, (B, H, W, .)
        float32."""
        logits = _nhwc(self.cls_out(F.relu(cf_fa))).float()
        raw = _nhwc(self.loc_refine_out(F.relu(lf_fa))).float()
        loc_refine = self._decode(raw, lvl, "refine")
        if self.res_refine:
            loc_refine = loc_refine + loc_init.detach()
        ctr = None
        if self.has_centerness:
            src = lf_fa if self.centerness_on_loc else cf_fa
            ctr = _nhwc(self.ctn_out(F.relu(src))).float()
        return logits, ctr, loc_refine

    def forward(self, feats: List[torch.Tensor]):
        out_cls, out_ctr, out_init, out_refine = [], [], [], []
        for lvl, x in enumerate(feats):
            b, _, h, w = x.shape
            n = h * w * self.num_anchors
            cf, lf = self.towers(x)
            loc_init = self.init_loc(lf, lvl)
            cf_fa, lf_fa = self.adapt(cf, lf, self.offsets(lf, loc_init, lvl))
            logits, ctr, loc_refine = self.outputs(cf_fa, lf_fa, loc_init, lvl)
            out_cls.append(logits.reshape(b, n, self.num_classes))
            out_init.append(loc_init.reshape(b, n, self.loc_dim))
            out_refine.append(loc_refine.reshape(b, n, self.loc_dim))
            if ctr is not None:
                out_ctr.append(ctr.reshape(b, n))
        return out_cls, out_ctr, out_init, out_refine


class AblationMetaArch(RepPointsModule):
    """Config-driven detector over the ablation chassis: target assignment,
    losses and inference dispatch on ``MODEL.META_ARCH.NAME``."""

    def __init__(self, cfg):
        if cfg.TPU.PACK_HEAD_LEVELS:
            raise NotImplementedError("TPU.PACK_HEAD_LEVELS is not ported")
        p = cfg.MODEL.META_ARCH
        if p.NAME not in HEADS:
            raise ValueError(f"MODEL.META_ARCH.NAME {p.NAME!r} is none of {HEADS}")
        is_lrtb = p.NAME.startswith("LRTB")
        is_pointset = p.NAME == "PointSetHead"
        is_anchor = p.NAME == "AnchorHead"
        if is_pointset and p.TRANSFORM_METHOD != "minmax":
            raise NotImplementedError(
                f"MODEL.META_ARCH.TRANSFORM_METHOD={p.TRANSFORM_METHOD!r}: the JAX "
                "PointSetHead passes no moment_transfer to points2bbox, so only "
                "'minmax' runs there")
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        self_strides = list(p.FPN_STRIDES)
        num_anchors, anchor_spec = 1, None
        if is_anchor:
            anchor_spec = AnchorGeneratorSpec(cfg, self_strides)
            num_anchors = anchor_spec.num_cell_anchors[0]
            assert all(a == num_anchors for a in anchor_spec.num_cell_anchors)
        head = MetaDualStageHead(
            in_channels=cfg.MODEL.FPN.OUT_CHANNELS, num_classes=p.NUM_CLASSES,
            loc_dim=4 if (is_lrtb or is_anchor) else 2 * p.NUM_POINTS,
            feat_adaption=p.FEAT_ADAPTION, num_convs=p.STACK_CONVS,
            feat_channels=p.FEAT_CHANNELS, norm=p.NORM, gradient_mul=p.GRADIENT_MUL,
            prior_prob=p.PRIOR_PROB, res_refine=p.RES_REFINE or is_pointset,
            has_centerness=is_lrtb, centerness_on_loc=p.CENTERNESS_ON_LOC,
            use_scales=is_lrtb, exp_decode=is_lrtb and not p.NORM_REG_TARGETS,
            strides=tuple(self_strides), num_anchors=num_anchors)
        super().__init__(backbone, head, p.IN_FEATURES, cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.head_name = p.NAME
        self.strides = self_strides
        self.anchor_spec = anchor_spec
        self.num_anchors = num_anchors
        self.num_classes = p.NUM_CLASSES
        self.focal_alpha = p.FOCAL_LOSS_ALPHA
        self.focal_gamma = p.FOCAL_LOSS_GAMMA
        self.loss_cls_weight = p.LOSS_CLS_WEIGHT
        self.loss_init_weight = p.LOSS_LOC_INIT_WEIGHT
        self.loss_refine_weight = p.LOSS_LOC_REFINE_WEIGHT
        self.iou_loss_type = p.IOU_LOSS_TYPE
        self.slender_centerness = p.SLENDER_CENTERNESS
        self.score_thresh = p.SCORE_THRESH_TEST
        self.topk_candidates = p.TOPK_CANDIDATES_TEST
        self.nms_thresh = p.NMS_THRESH_TEST
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.num_points = p.NUM_POINTS
        self.point_base_scale = p.POINT_BASE_SCALE
        self.transform_method = p.TRANSFORM_METHOD
        self.iou_thresholds = list(p.IOU_THRESHOLDS)
        self.iou_labels = list(p.IOU_LABELS)
        self.bbox_reg_weights = tuple(p.BBOX_REG_WEIGHTS)
        self.point_strides = [s / self.strides[0] for s in self.strides]

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` and the cls bias at the focal prior."""
        init_detector_weights(self, generator)
        self.head.cls_out.bias.fill_(prior_bias(self.head.prior_prob))

    # ------------------------------------------------------------ helpers
    def _gt(self, batch, dev):
        return (torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
                torch.as_tensor(batch["gt_classes"], device=dev).long(),
                torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev))

    def _onehot(self, labels):
        """Rows of ``labels`` outside [0, C) (background, ignored) are 0."""
        classes = torch.arange(self.num_classes, device=labels.device)
        return (labels[..., None] == classes).float()

    def _total(self, loss_cls, loss_init, loss_refine, ctr_loss=None):
        total = (loss_cls * self.loss_cls_weight + loss_init * self.loss_init_weight
                 + loss_refine * self.loss_refine_weight)
        if ctr_loss is not None:
            total = total + ctr_loss * self.loss_cls_weight
        return total

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4) XYXY,
        "gt_classes": (B, G) int, "gt_valid": (B, G) bool} as numpy arrays
        or tensors. Returns the total loss and {"loss_cls", "loss_loc_init",
        "loss_loc_refine", "num_pos"} plus "centerness_loss" for LRTB."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        outputs = self(images)
        image_hw = tuple(images.shape[1:3])
        if self.head_name.startswith("LRTB"):
            return self._lrtb_loss(batch, image_hw, outputs)
        if self.head_name == "PointSetHead":
            return self._pointset_loss(batch, image_hw, outputs)
        return self._anchor_loss(batch, image_hw, outputs)

    def _lrtb_loss(self, batch, image_hw, outputs):
        cls_l, ctr_l, init_l, refine_l = outputs
        dev = cls_l[0].device
        locations_np, counts = fcos_locations(image_hw, self.strides)
        logits = torch.cat(cls_l, dim=1)
        ctr = torch.cat(ctr_l, dim=1)
        loc_init = torch.cat(init_l, dim=1)
        loc_refine = torch.cat(refine_l, dim=1)
        gt_boxes, gt_classes, gt_valid = self._gt(batch, dev)
        with torch.no_grad():
            labels, reg_targets, gt_inds = fcos_assign(
                torch.as_tensor(locations_np, device=dev),
                torch.as_tensor(sizes_of_interest(counts), device=dev),
                gt_boxes, gt_classes, gt_valid, self.num_classes)

        pos = labels < self.num_classes
        num_pos, pos_share = global_normalizer(pos.sum().float(), 1.0)
        cls_loss = sigmoid_focal_loss(logits, self._onehot(labels), self.focal_alpha,
                                      self.focal_gamma).sum() / pos_share

        # a safe target on non-positive rows BEFORE the losses
        safe_targets = torch.where(pos[..., None], reg_targets, 1.0)
        ctr_fn = (compute_slender_centerness_targets if self.slender_centerness
                  else compute_centerness_targets)
        ctr_targets = torch.where(pos, ctr_fn(safe_targets), 0.0)
        reg_pos = pos
        if self.head_name == "LRTBTopkHead":
            reg_pos = topk_per_gt_gate(ctr_targets, pos, gt_inds, gt_boxes.shape[1], 5)
        _, ctr_share = global_normalizer(torch.where(reg_pos, ctr_targets, 0.0).sum(), 1e-6)

        def reg_loss(pred):
            per = iou_loss_ltrb(pred, safe_targets, self.iou_loss_type)
            return torch.where(reg_pos, per * ctr_targets, 0.0).sum() / ctr_share

        loss_init, loss_refine = reg_loss(loc_init), reg_loss(loc_refine)
        ctr_loss = torch.where(pos, optax_sigmoid_ce(ctr, ctr_targets), 0.0).sum() / pos_share
        return self._total(cls_loss, loss_init, loss_refine, ctr_loss), {
            "loss_cls": cls_loss, "centerness_loss": ctr_loss, "loss_loc_init": loss_init,
            "loss_loc_refine": loss_refine, "num_pos": num_pos}

    def _centers(self, image_hw):
        """RepPoints' grid: (ix, iy) * stride without the half stride."""
        return point_grid(image_hw, self.strides)

    def _pointset_boxes(self, deltas_l, centers, counts):
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [points2bbox(d, centers[offsets[i]: offsets[i + 1]], self.point_strides[i],
                            self.transform_method)
                for i, d in enumerate(deltas_l)]

    def _pointset_loss(self, batch, image_hw, outputs):
        cls_l, _, init_l, refine_l = outputs
        dev = cls_l[0].device
        centers_np, counts, lvls_np = self._centers(image_hw)
        centers = torch.as_tensor(centers_np, device=dev)
        lvls = torch.as_tensor(lvls_np, device=dev)
        lvl_min, lvl_max = int(np.log2(self.strides[0])), int(np.log2(self.strides[-1]))
        logits = torch.cat(cls_l, dim=1)
        init_boxes = torch.cat(self._pointset_boxes(init_l, centers, counts), dim=1)
        refine_boxes = torch.cat(self._pointset_boxes(refine_l, centers, counts), dim=1)
        stride_per_loc = torch.as_tensor(np.concatenate([
            np.full(c, s, np.float32) for c, s in zip(counts, self.strides)]), device=dev)
        gt_boxes, gt_classes, gt_valid = self._gt(batch, dev)

        with torch.no_grad():
            init_obj, init_gt, gt_cls, refine_gt = [], [], [], []
            for b in range(gt_boxes.shape[0]):
                obj, boxes = rep_points_assign(centers, lvls, gt_boxes[b], gt_valid[b],
                                               lvl_min, lvl_max, float(self.point_base_scale))
                init_obj.append(obj)
                init_gt.append(boxes)
                midx, mlab = iou_matcher(init_boxes[b].detach(), gt_boxes[b], gt_valid[b],
                                         self.iou_thresholds, self.iou_labels,
                                         allow_low_quality_matches=True)
                midx = midx.long()
                cls = torch.where(mlab == 1, gt_classes[b][midx], self.num_classes)
                gt_cls.append(torch.where(mlab == -1, -1, cls))
                refine_gt.append(gt_boxes[b][midx])
            init_obj, init_gt = torch.stack(init_obj), torch.stack(init_gt)
            gt_cls, refine_gt = torch.stack(gt_cls), torch.stack(refine_gt)

        valid = gt_cls >= 0
        fg = valid & (gt_cls < self.num_classes)
        # the global batch's foreground a image, clamped (one all-reduce)
        num_fg, num_init = global_sum(torch.stack([fg.sum(), init_obj.sum()]))
        normalizer = process_share(
            torch.clamp(num_fg.float() / (fg.shape[0] * process_count()), min=1.0))
        cls_all = sigmoid_focal_loss(logits, self._onehot(gt_cls), self.focal_alpha,
                                     self.focal_gamma)
        cls_loss = torch.where(valid[..., None], cls_all, 0.0).sum() / normalizer

        norm = (stride_per_loc * self.point_base_scale)[None, :, None]

        def box_loss(boxes, target, mask):
            safe = torch.where(mask[..., None], target, 1.0)
            per = smooth_l1_loss(boxes / norm, safe / norm, 0.11)
            return torch.where(mask[..., None], per, 0.0).sum()

        loss_init = (box_loss(init_boxes, init_gt, init_obj)
                     / process_share(torch.clamp(num_init.float(), min=1.0)))
        loss_refine = box_loss(refine_boxes, refine_gt, fg) / normalizer
        return self._total(cls_loss, loss_init, loss_refine), {
            "loss_cls": cls_loss, "loss_loc_init": loss_init, "loss_loc_refine": loss_refine,
            "num_pos": num_fg}

    def _anchor_loss(self, batch, image_hw, outputs):
        cls_l, _, init_l, refine_l = outputs
        dev = cls_l[0].device
        anchors = torch.as_tensor(self.anchor_spec.anchors(image_hw)[0], device=dev)
        logits = torch.cat(cls_l, dim=1)
        init_d = torch.cat(init_l, dim=1)
        refine_d = torch.cat(refine_l, dim=1)
        gt_boxes, gt_classes, gt_valid = self._gt(batch, dev)
        with torch.no_grad():
            gt_labels, matched = zip(*[retinanet_label_anchors(
                anchors, gt_boxes[b], gt_classes[b], gt_valid[b], self.iou_thresholds,
                self.iou_labels, self.num_classes) for b in range(gt_boxes.shape[0])])
            gt_labels, matched = torch.stack(gt_labels), torch.stack(matched)

        valid = gt_labels >= 0
        fg = valid & (gt_labels < self.num_classes)
        num_fg, fg_share = global_normalizer(fg.sum().float(), 1.0)
        cls_all = sigmoid_focal_loss(logits, self._onehot(gt_labels), self.focal_alpha,
                                     self.focal_gamma)
        cls_loss = torch.where(valid[..., None], cls_all, 0.0).sum() / fg_share

        safe = torch.where(fg[..., None], matched, anchors[None] + 1.0)
        target = box_ops.get_deltas(anchors[None].expand_as(safe), safe,
                                    weights=self.bbox_reg_weights)

        def delta_loss(pred):
            per = smooth_l1_loss(pred, target, 0.11)
            return torch.where(fg[..., None], per, 0.0).sum() / fg_share

        loss_init, loss_refine = delta_loss(init_d), delta_loss(refine_d)
        return self._total(cls_loss, loss_init, loss_refine), {
            "loss_cls": cls_loss, "loss_loc_init": loss_init, "loss_loc_refine": loss_refine,
            "num_pos": num_fg}

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,),
        "orig_size": (B, 2)} as numpy arrays or tensors. Returns fixed-shape
        detections in original image coordinates: boxes (B, D, 4), scores
        (B, D), classes (B, D) int32 and valid (B, D) bool."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            outputs = self(images)
        return self.postprocess(outputs, tuple(images.shape[1:3]),
                                torch.as_tensor(batch["scale"], device=dev),
                                torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, outputs, image_hw):
        """The NMS's input from the head's outputs: boxes (B, N, 4), scores
        (B, N), classes (B, N) int32 and valid (B, N) bool, with N the
        levels' top-k counts summed. LRTB: FCOS's candidates (the threshold
        before the top-k, ranked by cls x centerness, the square root as the
        score); PointSet and Anchor: the top-k of the sigmoid scores, then
        the threshold as a mask."""
        cls_l, ctr_l, _, refine_l = outputs
        dev = cls_l[0].device
        cands = []
        if self.head_name.startswith("LRTB"):
            locations_np, counts = fcos_locations(image_hw, self.strides)
            offsets = np.concatenate([[0], np.cumsum(counts)])
            for lvl in range(len(counts)):
                locs = torch.as_tensor(locations_np[offsets[lvl]: offsets[lvl + 1]],
                                       device=dev)
                cands.append(_fcos_level_candidates(
                    cls_l[lvl], refine_l[lvl], ctr_l[lvl], locs, self.score_thresh,
                    self.topk_candidates)[:4])
        elif self.head_name == "PointSetHead":
            centers_np, counts, _ = self._centers(image_hw)
            boxes_l = self._pointset_boxes(refine_l, torch.as_tensor(centers_np, device=dev),
                                           counts)
            for logits, boxes in zip(cls_l, boxes_l):
                top_scores, loc_idx, cls_idx = pair_top_k(torch.sigmoid(logits.float()),
                                                          self.topk_candidates)
                sel = torch.gather(boxes, 1, loc_idx[..., None].expand(-1, -1, 4))
                cands.append((sel, top_scores, cls_idx, top_scores > self.score_thresh))
        else:
            anchors_np, counts = self.anchor_spec.anchors(image_hw)
            offsets = np.concatenate([[0], np.cumsum(counts)])
            for lvl in range(len(counts)):
                anchors = torch.as_tensor(anchors_np[offsets[lvl]: offsets[lvl + 1]],
                                          device=dev)
                cands.append(_retina_level_candidates(
                    cls_l[lvl], refine_l[lvl], anchors, self.score_thresh,
                    self.topk_candidates, self.bbox_reg_weights)[:4])
        return tuple(torch.cat(t, dim=1) for t in zip(*cands))

    def postprocess(self, outputs, image_hw, scale, orig_size) -> Dict[str, torch.Tensor]:
        """Candidates, one NMS over all levels, rescaling and clipping."""
        return nms_detections(*self.candidates(outputs, image_hw), self.nms_thresh,
                              self.max_dets, scale, orig_size)
