"""Generalized R-CNN / ProposalVisibleRCNN (counterpart of
``slenderobjdet_tpu/models/meta_arch/rcnn.py``: ``RCNNModule`` and
``ProposalVisibleRCNN``; the reference's Faster R-CNN whose inference also
returns the RPN's proposals, ``pvrcnn.py:10-63``).

The backbone (ResNet + FPN with P6 by max pool) feeds the RPN head
(``proposal_generator/rpn.py``) and, through the proposals, the ROI box
branch (``roi_heads/roi_heads.py``). Training draws its subsampling
priorities from ``batch["generator"]``, a ``torch.Generator`` on the model's
device that the trainer seeds a step (the JAX package's ``batch["rng"]``):
first the RPN's, image by image, then the ROI heads'. ``image_size`` (B, 2),
the unpadded (h, w) the loader reports, is where proposals are clipped;
without it, the padded size.

``with_anchor`` is ProposalVisibleRCNNWithAnchor: each proposal keeps its
source anchor and each detection its (proposal, anchor) pair. The rotated
two-stage detector (PROPOSAL_GENERATOR "RRPN" or ROI_HEADS "RROIHeads",
the reference's ``configs/rotated/Base-RRCNN-FPN.yaml``) swaps in the XYWHA
machinery wholesale: ``RotatedRPN`` with a 5-delta RPN head,
``RotatedROIHeads``, ``gt_rboxes`` as the ground truth and XYWHA
detections and proposals (cx, cy, w, h over the scale, the angle as it
is). ``TPU.INT8_PREDICT`` runs the network of ``predict`` (trunk, FPN, RPN
head and box features) under ``ops.quant.int8_predict_scope``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ...ops.quant import int8_predict_scope
from ..backbones.fpn import build_backbone
from ..layers import init_detector_weights, uses_batch_statistics
from ..proposal_generator.rpn import RPN, StandardRPNHead
from ..proposal_generator.rrpn import RotatedRPN
from ..roi_heads.roi_heads import StandardROIHeads
from ..roi_heads.rotated import RotatedROIHeads


class RCNNModule(nn.Module):
    """Backbone and RPN head over uint8 NHWC images: the image is normalised
    in float32 and cast to the compute dtype. Returns the RPN's per-level
    logits and deltas and the ROI levels (in the compute dtype)."""

    def __init__(self, backbone: nn.Module, rpn_head: StandardRPNHead,
                 rpn_in_features: Sequence[str], roi_in_features: Sequence[str],
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone
        self.rpn_head = rpn_head
        self.rpn_in_features = tuple(rpn_in_features)
        self.roi_in_features = tuple(roi_in_features)
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)

    def forward(self, images: torch.Tensor):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        feats = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        logits_l, deltas_l = self.rpn_head([feats[f] for f in self.rpn_in_features])
        return logits_l, deltas_l, [feats[f] for f in self.roi_in_features]


class ProposalVisibleRCNN(RCNNModule):
    """Config-driven Faster R-CNN. ``predict`` returns the detections and the
    RPN's proposals (``proposals``, ``proposal_scores``, ``proposal_valid``;
    with ``with_anchor`` also ``proposal_anchors``, ``det_proposals`` and
    ``anchors``)."""

    def __init__(self, cfg, with_anchor: bool = False):
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        backbone = build_backbone(cfg)
        rpn_in = list(cfg.MODEL.RPN.IN_FEATURES)
        roi_in = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        rotated = (cfg.MODEL.PROPOSAL_GENERATOR.NAME == "RRPN"
                   or cfg.MODEL.ROI_HEADS.NAME == "RROIHeads")
        rpn = (RotatedRPN if rotated else RPN)(cfg, [backbone.strides[f] for f in rpn_in])
        roi_heads = (RotatedROIHeads if rotated else StandardROIHeads)(
            cfg, [backbone.strides[f] for f in roi_in])
        channels = cfg.MODEL.FPN.OUT_CHANNELS
        super().__init__(backbone, StandardRPNHead(channels, rpn.num_cell_anchors,
                                                   box_dim=5 if rotated else 4),
                         rpn_in, roi_in, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                         dtype)
        self.int8_predict = cfg.TPU.INT8_PREDICT
        self.roi_box = roi_heads.build_module(channels, dtype)
        self.rpn = rpn
        self.roi_heads = roi_heads
        self.rotated = rotated
        self.with_anchor = not rotated and (
            with_anchor or cfg.MODEL.PROPOSAL_GENERATOR.NAME == "RPNWithAnchor")
        self.max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
        self._anchors = {}

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_detector_weights`` for the trunk, then the JAX package's
        initialisers: the RPN head's convs normal(0, 0.01), the fully
        connected layers lecun-normal (untruncated), cls_score normal(0,
        0.01), bbox_pred normal(0, 0.001), every bias 0."""
        init_detector_weights(self, generator)

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        for conv in (self.rpn_head.conv, self.rpn_head.objectness_logits,
                     self.rpn_head.anchor_deltas):
            normal(conv.weight, 0.01)
        for name, layer in self.roi_box.named_modules():
            if isinstance(layer, nn.Linear):
                std = {"outputs.cls_score": 0.01, "outputs.bbox_pred": 0.001}.get(
                    name, 1.0 / math.sqrt(layer.in_features))
                normal(layer.weight, std)
                layer.bias.zero_()

    def rpn_anchors(self, image_hw) -> Tuple[torch.Tensor, list]:
        """The RPN's anchors (N, 4), or (N, 5) rotated, on the model's
        device and the per-level counts, for a padded image shape (kept for
        the shapes seen, except while ``torch.export`` traces, whose tensors
        must not outlive the trace)."""
        dev = self.pixel_mean.device
        key = (tuple(int(v) for v in image_hw), str(dev))
        if key in self._anchors:
            return self._anchors[key]
        anchors, counts = self.rpn.anchor_spec.anchors(key[0])
        entry = (torch.as_tensor(anchors, device=dev), counts)
        if not torch.compiler.is_compiling():
            self._anchors[key] = entry
        return entry

    def _image_sizes(self, batch, images) -> torch.Tensor:
        if "image_size" in batch:
            return torch.as_tensor(batch["image_size"], device=images.device)
        return torch.tensor(images.shape[1:3], device=images.device).expand(
            images.shape[0], 2)

    # --------------------------------------------------------------- loss
    @uses_batch_statistics
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"image": uint8 (B, H, W, 3), "gt_boxes": (B, G, 4) (the
        rotated detector: "gt_rboxes" (B, G, 5)), "gt_classes": (B, G),
        "gt_valid": (B, G)} as numpy arrays or tensors, and optionally
        "image_size" (B, 2) and "generator" (seed 0 when absent). Returns the
        total and {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
        "num_fg"}."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        generator = batch.get("generator")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        gt_boxes = torch.as_tensor(batch["gt_rboxes" if self.rotated else "gt_boxes"],
                                   dtype=torch.float32, device=dev)
        gt_classes = torch.as_tensor(batch["gt_classes"], device=dev)
        gt_valid = torch.as_tensor(batch["gt_valid"], dtype=torch.bool, device=dev)

        logits_l, deltas_l, roi_feats = self(images)
        logits = torch.cat(logits_l, dim=1)
        deltas = torch.cat(deltas_l, dim=1)
        anchors, counts = self.rpn_anchors(images.shape[1:3])

        metrics = self.rpn.losses(anchors, logits, deltas, gt_boxes, gt_classes,
                                  gt_valid, generator)
        with torch.no_grad():
            proposals, _, prop_valid = self.rpn.proposals(
                anchors, counts, logits.detach(), deltas.detach(),
                self._image_sizes(batch, images), train=True)
        metrics.update(self.roi_heads.losses(
            self.roi_box, roi_feats, proposals, prop_valid, gt_boxes, gt_classes,
            gt_valid, generator))
        total = (metrics["loss_rpn_cls"] + metrics["loss_rpn_loc"]
                 + metrics["loss_cls"] + metrics["loss_box_reg"])
        return total, metrics

    # ---------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch: {"image": uint8 (B, H, W, 3), "scale": (B,), "orig_size":
        (B, 2)} and optionally "image_size" (B, 2). Returns the detections
        (boxes (B, D, 4), scores, classes int32, valid) in original image
        coordinates and the proposals (B, K, 4) rescaled by ``scale``, their
        scores (the RPN's logits) and validity."""
        dev = self.pixel_mean.device
        images = torch.as_tensor(batch["image"], device=dev)
        with int8_predict_scope(self.int8_predict):
            logits_l, deltas_l, roi_feats = self(images)
        anchors, counts = self.rpn_anchors(images.shape[1:3])
        proposals, prop_scores, prop_valid, *prop_anchors = self.rpn.proposals(
            anchors, counts, torch.cat(logits_l, dim=1), torch.cat(deltas_l, dim=1),
            self._image_sizes(batch, images), train=False, with_anchors=self.with_anchor)
        prop_anchors = prop_anchors[0] if prop_anchors else None
        scale = torch.as_tensor(batch["scale"], device=dev)
        out = self.roi_heads.inference(
            self.roi_box, roi_feats, proposals, prop_valid, scale,
            torch.as_tensor(batch["orig_size"], device=dev), prop_anchors=prop_anchors)
        scale = scale.float()[:, None, None]
        out["proposals"] = (torch.cat([proposals[..., :4] / scale, proposals[..., 4:]], -1)
                            if self.rotated else proposals / scale)
        out["proposal_scores"] = prop_scores
        out["proposal_valid"] = prop_valid
        if prop_anchors is not None:
            out["proposal_anchors"] = prop_anchors / scale
        return out
