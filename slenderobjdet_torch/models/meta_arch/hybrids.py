"""Variant meta-architectures on the RetinaNet chassis (counterpart of
``slenderobjdet_tpu/models/meta_arch/hybrids.py``). Each reuses the core
machinery: ``FCOSRetinaNet`` and ``FCOSNCRetinaNet`` are FCOS heads (ltrb at
locations) with and without the centerness branch, the centerness ablation
pair; ``PointRetinaNet`` is RetinaNet with the nearest-point assignment. The
RepPoints hybrids of that file come with deformable convolution.
"""

from __future__ import annotations

from .fcos import FCOS
from .retinanet import RetinaNet


class FCOSRetinaNet(FCOS):
    """FCOS head with the centerness branch: focal loss over num_pos, IoU
    loss weighted by the centerness targets over their sum, centerness BCE
    over num_pos, inference ranked by sqrt(cls * ctr)."""

    def __init__(self, cfg):
        super().__init__(cfg, use_centerness=True)


class FCOSNCRetinaNet(FCOS):
    """The no-centerness partner: a head without the centerness conv, the
    regression loss over num_pos, inference ranked by the raw class score."""

    def __init__(self, cfg):
        super().__init__(cfg, use_centerness=False)


class PointRetinaNet(RetinaNet):
    """RetinaNet with point-based (nearest at the gt's level) assignment."""

    def __init__(self, cfg):
        super().__init__(cfg, assign_mode="nearest")
