"""The RepPoints detector (counterpart of
``slenderobjdet_tpu/models/meta_arch/reppoints.py``: ``DeformConvLayer``,
``RepPointsHead``, ``RepPointsModule``, ``points2bbox``,
``rep_points_assign``, ``inside_assign``, ``rep_points_assign_with_idx`` and
``RepPointsDetector``).

- Shared 3 x (conv + GroupNorm + relu) cls and reg towers; an
  ``offsets_init`` stack gives 2P point offsets, (x, y) pairs in stride
  units; the two deformable convs sample at those points, blended by
  ``gradient_mul`` and flipped to (dy, dx), from ONE gather over the
  channel-concatenated tower outputs; the refine offsets are added to the
  detached init offsets.
- ``points2bbox`` turns a point set into a box (``minmax``, or ``moment``
  with a learned ``moment_transfer``), scaled by the level's point stride
  ``stride / strides[0]``; the centres are ``(ix, iy) * stride`` with no
  half-stride shift.
- Init-stage targets by the nearest point(s) at the gt's pyramid level
  (``MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE``: ``point(s)``, ``nearest_points``
  or ``inside``), refine-stage targets by the IoU matcher on the detached
  init boxes; focal loss and smooth-L1 (beta 0.11) on boxes over
  4 x stride, the init term weighted 0.5, over the EMA loss normaliser.
- The EMA normaliser (init 20, momentum 0.9, updated before use) is the
  buffer ``loss_normalizer``: ``loss`` reports the updated value under
  ``metrics["loss_normalizer"]`` and ``engine/train_loop.py:TrainStep``
  writes it back after the update, so ``loss`` itself mutates nothing and
  the value rides in ``state_dict`` and so in checkpoints.
- Inference as RetinaNet's: per-level pair top-k of the sigmoid scores, the
  score threshold as a mask, the refine boxes, then class-aware greedy NMS,
  on CUDA tensors the hand-written kernel (``ops/nms.py:cuda_batched_nms``).

``TRANSFORM_METHOD: moment`` cannot run in the JAX detector, which passes no
``moment_transfer`` to ``points2bbox``; the port's detector raises at
construction instead.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import deform_sample_batched
from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.nms import cuda_batched_nms
from ...ops.quant import int8_predict_scope
from ...ops.topk import pair_top_k
from ...parallel.multihost import global_sum, process_count, process_share
from ...structures import boxes as box_ops
from ..anchors import feature_map_shapes
from ..backbones.fpn import build_backbone
from ..layers import (Conv2d, DeformConvLayer, GroupNorm32,
                      init_detector_weights, prior_bias,
                      uses_batch_statistics)
from ..matchers import iou_matcher

__all__ = ["DeformConvLayer", "RepPointsHead", "RepPointsModule", "nms_detections",
           "point_grid", "points2bbox",
           "rep_points_assign", "inside_assign", "rep_points_assign_with_idx",
           "RepPointsDetector"]


class RepPointsHead(nn.Module):
    """The point-set head over NCHW pyramid levels. ``forward`` returns
    per-level lists of (B, H*W, num_classes) logits and (B, H*W, 2P) init and
    refine offsets, float32, row-major (h, w); the offsets are (x, y) pairs in
    units of the level's point stride."""

    def __init__(self, in_channels: int, num_classes: int, num_points: int = 9,
                 feat_channels: int = 256, stack_convs: int = 3,
                 gradient_mul: float = 0.1, prior_prob: float = 0.01):
        super().__init__()
        c = feat_channels
        self.num_classes = num_classes
        self.num_points = num_points
        self.stack_convs = stack_convs
        self.gradient_mul = gradient_mul
        self.prior_prob = prior_prob
        for prefix in ("cls", "reg"):
            for i in range(stack_convs):
                self.add_module(f"{prefix}_conv{i}",
                                Conv2d(in_channels if i == 0 else c, c, 3, padding=1))
                self.add_module(f"{prefix}_gn{i}", GroupNorm32(c))
        self.offsets_init_conv = Conv2d(c, c, 3, padding=1)
        self.offsets_init_out = Conv2d(c, 2 * num_points, 1)
        self.deform_cls_conv = DeformConvLayer(c, c)
        self.deform_reg_conv = DeformConvLayer(c, c)
        self.logits_out = Conv2d(c, num_classes, 1)
        self.offsets_refine_out = Conv2d(c, 2 * num_points, 1)

    def towers(self, x):
        """The cls and reg tower outputs of one level, NCHW."""
        cf, rf = x, x
        for i in range(self.stack_convs):
            cf = F.relu(getattr(self, f"cls_gn{i}")(getattr(self, f"cls_conv{i}")(cf)))
            rf = F.relu(getattr(self, f"reg_gn{i}")(getattr(self, f"reg_conv{i}")(rf)))
        return cf, rf

    def init_offsets(self, rf):
        """(B, H, W, 2P) float32 init offsets from the reg tower."""
        out = self.offsets_init_out(F.relu(self.offsets_init_conv(rf)))
        return out.float().permute(0, 2, 3, 1)

    def sample(self, cf, rf, off_init):
        """The gather the two deform convs share: (B, H, W, K, 2C) samples of
        the concatenated towers at the ``gradient_mul`` blend of the init
        points, flipped to (dy, dx)."""
        b, h, w, _ = off_init.shape
        g = self.gradient_mul
        blend = (1 - g) * off_init.detach() + g * off_init
        pts = blend.reshape(b, h, w, self.num_points, 2).flip(-1)
        cat = torch.cat([cf.permute(0, 2, 3, 1), rf.permute(0, 2, 3, 1)], dim=-1)
        return deform_sample_batched(cat, pts)

    def deform_convs(self, samples):
        """The cls and reg deform convs' matmuls on the shared samples:
        (B, H, W, C) each in the samples' dtype."""
        c = samples.shape[-1] // 2
        return (self.deform_cls_conv(samples=samples[..., :c]),
                self.deform_reg_conv(samples=samples[..., c:]))

    def outputs(self, dc, dr, off_init):
        """Logits and refine offsets (B, H, W, .) float32 from the deform
        convs' (B, H, W, C) outputs."""
        def conv1x1(conv, t):
            return conv(F.relu(t).permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)

        logits = conv1x1(self.logits_out, dc)
        off_refine = conv1x1(self.offsets_refine_out, dr) + off_init.detach()
        return logits, off_refine

    def forward(self, feats: List[torch.Tensor]):
        all_logits, all_init, all_refine = [], [], []
        for x in feats:
            b, _, h, w = x.shape
            cf, rf = self.towers(x)
            off_init = self.init_offsets(rf)
            dc, dr = self.deform_convs(self.sample(cf, rf, off_init))
            logits, off_refine = self.outputs(dc, dr, off_init)
            all_logits.append(logits.reshape(b, h * w, self.num_classes))
            all_init.append(off_init.reshape(b, h * w, 2 * self.num_points))
            all_refine.append(off_refine.reshape(b, h * w, 2 * self.num_points))
        return all_logits, all_init, all_refine


class RepPointsModule(nn.Module):
    """Backbone + FPN + a head over uint8 NHWC images (the point-set head;
    the ablation chassis and FCOSAnchor reuse it); the image is normalised
    in float32 and then cast to the compute dtype."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
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

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = (images.float() - self.pixel_mean) / self.pixel_std
        # NHWC -> NCHW view, which is channels_last memory
        feats = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        return [feats[f] for f in self.in_features]

    def forward(self, images: torch.Tensor):
        return self.head(self.features(images))


def point_grid(image_hw, strides):
    """Point centres (L, 2) xy at (ix, iy) * stride (no half-stride shift),
    the level counts and each point's level (log2 of its stride), numpy."""
    centers, counts, lvls = [], [], []
    for (h, w), s in zip(feature_map_shapes(image_hw, strides), strides):
        xg, yg = np.meshgrid(np.arange(w, dtype=np.float32) * s,
                             np.arange(h, dtype=np.float32) * s)
        centers.append(np.stack([xg.reshape(-1), yg.reshape(-1)], 1))
        counts.append(h * w)
        lvls.append(np.full(h * w, int(np.log2(s)), np.int32))
    return np.concatenate(centers), counts, np.concatenate(lvls)


def nms_detections(boxes, scores, classes, valid, nms_thresh: float, max_dets: int, scale,
                   orig_size) -> Dict[str, torch.Tensor]:
    """One class-aware NMS over every level's candidates (on CUDA tensors the
    hand-written kernel), then the kept boxes rescaled by ``scale`` (B,) and
    clipped to ``orig_size`` (B, 2): boxes (B, D, 4), scores (B, D), classes
    (B, D) int32 and valid (B, D) bool."""
    keep_idx, keep_valid = cuda_batched_nms(boxes, scores, classes, nms_thresh, max_dets,
                                            valid=valid)
    keep = keep_idx.long()
    orig = orig_size.float()
    kb = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
    kb = box_ops.clip(kb / scale.float()[:, None, None], orig[:, 0:1], orig[:, 1:2])
    return {"boxes": kb, "scores": torch.gather(scores, 1, keep),
            "classes": torch.gather(classes, 1, keep), "valid": keep_valid}


def points2bbox(deltas, centers, point_stride, method="minmax",
                moment_transfer=None, moment_mul=0.01):
    """deltas (B, L, 2P) (x, y) pairs; centers (L, 2) -> (B, L, 4) XYXY."""
    B, L, twoP = deltas.shape
    pts = deltas.reshape(B, L, twoP // 2, 2) * point_stride + centers[None, :, None, :]
    px, py = pts[..., 0], pts[..., 1]
    if method == "minmax":
        return torch.stack([px.amin(-1), py.amin(-1), px.amax(-1), py.amax(-1)], dim=-1)
    if method == "moment":
        mx, my = px.mean(-1), py.mean(-1)
        # gradient-safe std: eps inside the sqrt, whose gradient is inf
        # where all P points coincide
        sx = torch.sqrt(torch.mean(torch.square(px - mx[..., None]), -1) + 1e-12)
        sy = torch.sqrt(torch.mean(torch.square(py - my[..., None]), -1) + 1e-12)
        mt = moment_transfer * moment_mul + moment_transfer.detach() * (1 - moment_mul)
        hw_ = sx * torch.exp(mt[0])
        hh = sy * torch.exp(mt[1])
        return torch.stack([mx - hw_, my - hh, mx + hw_, my + hh], dim=-1)
    raise ValueError(method)


def _gt_geometry(gt_boxes, scale, lvl_min, lvl_max):
    """Each gt's centre, size (floored at 1e-6) and pyramid level: the mean
    of log2(w / scale) and log2(h / scale) truncated toward zero, clipped."""
    gt_xy = (gt_boxes[:, :2] + gt_boxes[:, 2:]) / 2
    gt_wh = torch.clamp(gt_boxes[:, 2:] - gt_boxes[:, :2], min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[:, 0] / scale) + torch.log2(gt_wh[:, 1] / scale))
              / 2).to(torch.int32)
    return gt_xy, gt_wh, torch.clamp(gt_lvl, lvl_min, lvl_max)


def _center_distance(centers, gt_xy, gt_wh):
    """(G, L) distances from each gt's centre in units of its size."""
    delta = (centers[None, :, :] - gt_xy[:, None, :]) / gt_wh[:, None, :]
    return torch.sqrt((delta * delta).sum(dim=-1))


def rep_points_assign_with_idx(centers, point_lvls, gt_boxes, gt_valid,
                               lvl_min, lvl_max, scale=4.0, pos_num=1):
    """Each valid gt claims the ``pos_num`` points nearest to its centre on its
    own pyramid level; a point claimed by several gt goes to the nearest.

    centers (L, 2) xy, point_lvls (L,) int (log2 of the stride), gt_boxes
    (G, 4) XYXY, gt_valid (G,) bool. Returns objectness (L,) bool and the
    matched gt index (L,) (0 where nothing matched). Ties in distance go to
    the lowest point index, as ``jax.lax.top_k`` takes them; a padded gt has
    every distance at inf and picks nothing."""
    gt_xy, gt_wh, gt_lvl = _gt_geometry(gt_boxes, scale, lvl_min, lvl_max)
    d = _center_distance(centers, gt_xy, gt_wh)                     # (G, L)
    on_lvl = point_lvls[None, :] == gt_lvl[:, None]
    inf = torch.full_like(d, float("inf"))
    d = torch.where(on_lvl & gt_valid[:, None], d, inf)
    if pos_num == 1:
        top_idx = torch.argmin(d, dim=1, keepdim=True)              # first minimum
    else:
        top_idx = torch.sort(d, dim=1, stable=True)[1][:, :pos_num]
    vals = torch.gather(d, 1, top_idx)      # inf where the gt picked nothing
    cand = inf.scatter_reduce(1, top_idx, vals, "amin")
    best = cand.amin(dim=0)
    best_gt = torch.argmin(cand, dim=0)
    return torch.isfinite(best), best_gt


def rep_points_assign(centers, point_lvls, gt_boxes, gt_valid, lvl_min, lvl_max,
                      scale=4.0, pos_num=1):
    """``rep_points_assign_with_idx`` returning (objectness (L,) bool, the
    matched gt boxes (L, 4))."""
    obj, idx = rep_points_assign_with_idx(centers, point_lvls, gt_boxes, gt_valid,
                                          lvl_min, lvl_max, scale, pos_num)
    return obj, gt_boxes[idx]


def inside_assign(centers, point_lvls, stride_per_loc, gt_boxes, gt_valid,
                  lvl_min, lvl_max, scale=4.0):
    """A point is positive where its stride cell overlaps a valid gt box at
    the gt's pyramid level, with the box of the nearest valid gt centre;
    when no point of the image is inside any box, the nearest-point
    assignment instead. Returns (objectness (L,) bool, boxes (L, 4))."""
    gt_xy, gt_wh, gt_lvl = _gt_geometry(gt_boxes, scale, lvl_min, lvl_max)
    on_lvl = point_lvls[None, :] == gt_lvl[:, None]                 # (G, L)
    upper = centers + stride_per_loc[:, None]
    inside = ((upper[None, :, 0] >= gt_boxes[:, None, 0])
              & (upper[None, :, 1] >= gt_boxes[:, None, 1])
              & (centers[None, :, 0] <= gt_boxes[:, None, 2])
              & (centers[None, :, 1] <= gt_boxes[:, None, 3])
              & on_lvl & gt_valid[:, None])
    obj_inside = inside.any(dim=0)
    d = _center_distance(centers, gt_xy, gt_wh)
    d = torch.where(gt_valid[:, None], d, float("inf"))
    boxes_inside = gt_boxes[torch.argmin(d, dim=0)]
    obj_near, boxes_near = rep_points_assign(centers, point_lvls, gt_boxes, gt_valid,
                                             lvl_min, lvl_max, scale, 1)
    any_inside = obj_inside.any()
    return (torch.where(any_inside, obj_inside, obj_near),
            torch.where(any_inside, boxes_inside, boxes_near))


class RepPointsDetector(RepPointsModule):
    """Config-driven RepPoints (the interface of ``RetinaNet``)."""

    head_class = RepPointsHead
    # stage-1 positives a gt (FCOSRepPoints widens this to 3)
    init_pos_num = 1
    # the EMA loss normaliser (RepPointsV2 has none)
    uses_loss_normalizer = True
    loss_normalizer_momentum = 0.9
    loss_normalizer_init = 20.0

    @classmethod
    def settings(cls, cfg) -> Dict:
        """The config keys the detector reads, by its own names."""
        rp, rn = cfg.MODEL.REPPOINTS, cfg.MODEL.RETINANET
        return dict(
            num_classes=rn.NUM_CLASSES, in_features=list(rn.IN_FEATURES),
            focal_alpha=rn.FOCAL_LOSS_ALPHA, focal_gamma=rn.FOCAL_LOSS_GAMMA,
            topk_candidates=rn.TOPK_CANDIDATES_TEST, score_thresh=rn.SCORE_THRESH_TEST,
            nms_thresh=rn.NMS_THRESH_TEST, num_points=rp.NUM_POINTS,
            transform_method=rp.TRANSFORM_METHOD, feat_channels=rp.POINT_FEAT_CHANNELS,
            stack_convs=rp.STACK_CONVS, gradient_mul=rp.GRADIENT_MUL,
            prior_prob=rp.PRIOR_PROB, full_stride_points=False)

    def __init__(self, cfg):
        if cfg.TPU.PACK_HEAD_LEVELS:
            raise NotImplementedError("TPU.PACK_HEAD_LEVELS is not ported")
        s = self.settings(cfg)
        if s["transform_method"] != "minmax":
            raise NotImplementedError(
                f"MODEL.REPPOINTS.TRANSFORM_METHOD={s['transform_method']!r}: the "
                "RepPoints detectors decode with minmax only; the JAX detector "
                "passes no moment_transfer to points2bbox, so 'moment' cannot run "
                "there either")
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        head = self.head_class(
            in_channels=cfg.MODEL.FPN.OUT_CHANNELS, num_classes=s["num_classes"],
            num_points=s["num_points"], feat_channels=s["feat_channels"],
            stack_convs=s["stack_convs"], gradient_mul=s["gradient_mul"],
            prior_prob=s["prior_prob"])
        super().__init__(backbone, head, s["in_features"], cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD, dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.num_classes = s["num_classes"]
        self.focal_alpha = s["focal_alpha"]
        self.focal_gamma = s["focal_gamma"]
        self.topk_candidates = s["topk_candidates"]
        self.score_thresh = s["score_thresh"]
        self.nms_thresh = s["nms_thresh"]
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self.num_points = s["num_points"]
        self.transform_method = s["transform_method"]
        self.point_base_scale = cfg.MODEL.REPPOINTS.POINT_BASE_SCALE
        self.iou_thresholds = list(cfg.MODEL.RETINANET.IOU_THRESHOLDS)
        self.iou_labels = list(cfg.MODEL.RETINANET.IOU_LABELS)
        self.strides = [backbone.strides[f] for f in self.in_features]
        self.point_strides = [float(s_) if s["full_stride_points"]
                              else s_ // self.strides[0] * 1.0 for s_ in self.strides]
        # "point(s)": the init_pos_num nearest points, "nearest_points": the
        # nearest one, "inside": the stride cells inside the box
        self.sample_mode = cfg.MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE
        if self.uses_loss_normalizer:
            self.register_buffer("loss_normalizer",
                                 torch.tensor(self.loss_normalizer_init))

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights``, the cls bias at the focal prior and the
        loss normaliser at its initial value."""
        init_detector_weights(self, generator)
        self.head.logits_out.bias.fill_(prior_bias(self.head.prior_prob))
        if self.uses_loss_normalizer:
            self.loss_normalizer.fill_(self.loss_normalizer_init)

    # ----------------------------------------------------------- geometry
    def _centers(self, image_hw):
        return point_grid(image_hw, self.strides)

    def _decode_boxes(self, deltas_l, centers, counts):
        """Per-level (B, L_l, 4) boxes of per-level (B, L_l, 2P) offsets."""
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [points2bbox(d, centers[offsets[i]: offsets[i + 1]],
                            self.point_strides[i], self.transform_method)
                for i, d in enumerate(deltas_l)]

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4) XYXY,
        "gt_classes": (B, G) int, "gt_valid": (B, G) bool} as numpy arrays or
        tensors. Returns the total loss and {"loss_cls",
        "loss_localization_init", "loss_localization_refine", "num_pos",
        "loss_normalizer"}; the last is the EMA after this batch, which the
        train step writes back."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        logits_l, init_l, refine_l = self(images)[:3]
        return self._loss_from_outputs(batch, tuple(images.shape[1:3]),
                                       logits_l, init_l, refine_l)

    def _targets_input(self, batch, image_hw, logits_l, init_l, refine_l):
        """What the assignments and losses read: point geometry, decoded
        boxes, logits and the gt, on the model's device."""
        dev = self.pixel_mean.device
        centers_np, counts, lvls_np = self._centers(image_hw)
        centers = torch.as_tensor(centers_np, device=dev)
        return dict(
            centers=centers, counts=counts,
            lvls=torch.as_tensor(lvls_np, device=dev),
            stride_per_loc=torch.as_tensor(np.concatenate([
                np.full(c, s, np.float32) for c, s in zip(counts, self.strides)]),
                device=dev),
            init_boxes=torch.cat(self._decode_boxes(init_l, centers, counts), dim=1),
            refine_boxes=torch.cat(self._decode_boxes(refine_l, centers, counts), dim=1),
            logits=torch.cat(logits_l, dim=1),
            gt_boxes=torch.as_tensor(batch["gt_boxes"], dtype=torch.float32, device=dev),
            gt_classes=torch.as_tensor(batch["gt_classes"], device=dev).long(),
            gt_valid=torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev),
            lvl_min=int(np.log2(self.strides[0])), lvl_max=int(np.log2(self.strides[-1])))

    @torch.no_grad()
    def _init_targets(self, t):
        """Init-stage objectness (B, L) and gt boxes (B, L, 4), image by
        image, by SAMPLE_MODE; nothing depends on the predictions."""
        out = []
        for b in range(t["gt_boxes"].shape[0]):
            if self.sample_mode == "inside":
                out.append(inside_assign(
                    t["centers"], t["lvls"], t["stride_per_loc"], t["gt_boxes"][b],
                    t["gt_valid"][b], t["lvl_min"], t["lvl_max"],
                    float(self.point_base_scale)))
            else:
                pos_num = 1 if self.sample_mode == "nearest_points" else self.init_pos_num
                out.append(rep_points_assign(
                    t["centers"], t["lvls"], t["gt_boxes"][b], t["gt_valid"][b],
                    t["lvl_min"], t["lvl_max"], float(self.point_base_scale), pos_num))
        obj, boxes = zip(*out)
        return torch.stack(obj), torch.stack(boxes)

    @torch.no_grad()
    def _refine_targets(self, t):
        """Refine-stage classes (B, L) ([0, C-1] foreground, C background, -1
        ignored) and gt boxes (B, L, 4): the IoU matcher with low-quality
        matches on the detached init boxes."""
        labels, boxes = [], []
        for b in range(t["gt_boxes"].shape[0]):
            midx, mlab = iou_matcher(t["init_boxes"][b].detach(), t["gt_boxes"][b],
                                     t["gt_valid"][b], self.iou_thresholds,
                                     self.iou_labels, allow_low_quality_matches=True)
            midx = midx.long()
            cls = torch.where(mlab == 1, t["gt_classes"][b][midx], self.num_classes)
            labels.append(torch.where(mlab == -1, -1, cls))
            boxes.append(t["gt_boxes"][b][midx])
        return torch.stack(labels), torch.stack(boxes)

    def _box_loss(self, t, boxes, gt_boxes, mask):
        """Per-point smooth-L1 (beta 0.11) sums of the boxes over 4 x stride
        where ``mask``; masked rows get a safe target BEFORE the loss."""
        norm = (t["stride_per_loc"] * self.point_base_scale)[None, :, None]
        safe = torch.where(mask[..., None], gt_boxes, 1.0)
        per = smooth_l1_loss(boxes / norm, safe / norm, 0.11)
        return torch.where(mask[..., None], per, 0.0).sum()

    def _onehot(self, gt_cls):
        classes = torch.arange(self.num_classes, device=gt_cls.device)
        return (gt_cls[..., None] == classes).float()

    def _loss_from_outputs(self, batch, image_hw, logits_l, init_l, refine_l):
        return self._losses(self._targets_input(batch, image_hw, logits_l, init_l,
                                                refine_l))

    def _losses(self, t):
        init_obj, init_gt_boxes = self._init_targets(t)
        gt_cls, refine_gt_boxes = self._refine_targets(t)

        valid = gt_cls >= 0
        fg = valid & (gt_cls < self.num_classes)
        # counts over the global batch (one all-reduce), so that the buffer
        # is equal on every process
        num_fg, num_init = global_sum(torch.stack([fg.sum(), init_obj.sum()]))
        num_fg_per_img = num_fg.float() / (fg.shape[0] * process_count())
        # the EMA, updated before use
        m = self.loss_normalizer_momentum
        new_normalizer = m * self.loss_normalizer + (1.0 - m) * num_fg_per_img
        normalizer = process_share(torch.clamp(new_normalizer, min=1.0))

        cls_all = sigmoid_focal_loss(t["logits"], self._onehot(gt_cls),
                                     self.focal_alpha, self.focal_gamma)
        loss_cls = torch.where(valid[..., None], cls_all, 0.0).sum() / normalizer
        init_share = process_share(torch.clamp(num_init.float(), min=1.0))
        loss_init = (self._box_loss(t, t["init_boxes"], init_gt_boxes, init_obj)
                     / init_share * 0.5)
        loss_refine = self._box_loss(t, t["refine_boxes"], refine_gt_boxes, fg) / normalizer
        total = loss_cls + loss_init + loss_refine
        return total, {"loss_cls": loss_cls, "loss_localization_init": loss_init,
                       "loss_localization_refine": loss_refine, "num_pos": num_fg,
                       "loss_normalizer": new_normalizer.detach()}

    # ---------------------------------------------------------- inference
    def score_logits(self, outputs):
        """The per-level logits that rank the candidates."""
        return outputs[0]

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
        return self.postprocess(
            self.score_logits(outputs), outputs[2], tuple(images.shape[1:3]),
            torch.as_tensor(batch["scale"], device=dev),
            torch.as_tensor(batch["orig_size"], device=dev))

    def candidates(self, logits_l, refine_l, image_hw):
        """The NMS's input: boxes (B, N, 4), scores (B, N), classes (B, N)
        int32 and valid (B, N) bool, with N the levels' top-k counts
        summed: per level, the top-k (point, class) pairs of the sigmoid
        scores, THEN the score threshold as a mask, and their refine boxes."""
        centers_np, counts, _ = self._centers(image_hw)
        centers = torch.as_tensor(centers_np, device=logits_l[0].device)
        cands = []
        for logits, boxes in zip(logits_l, self._decode_boxes(refine_l, centers, counts)):
            scores = torch.sigmoid(logits.float())
            top_scores, loc_idx, cls_idx = pair_top_k(scores, self.topk_candidates)
            sel = torch.gather(boxes, 1, loc_idx[..., None].expand(-1, -1, 4))
            cands.append((sel, top_scores, cls_idx, top_scores > self.score_thresh))
        return tuple(torch.cat(t, dim=1) for t in zip(*cands))

    def postprocess(self, logits_l, refine_l, image_hw, scale,
                    orig_size) -> Dict[str, torch.Tensor]:
        """Candidates, NMS and rescaling from the head's per-level outputs."""
        return nms_detections(*self.candidates(logits_l, refine_l, image_hw),
                              self.nms_thresh, self.max_dets, scale, orig_size)
