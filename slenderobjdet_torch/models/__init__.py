"""Config-driven model construction (counterpart of
``slenderobjdet_tpu/models/__init__.py:build_model``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import quant
from .meta_arch.ablation import AblationMetaArch
from .meta_arch.corner_net import CornerNet
from .meta_arch.fcos import FCOS, FCOSTopK, FCOSV3
from .meta_arch.fcos_anchor import FCOSAnchor
from .meta_arch.proposal_network import ProposalNetworkWithMasks
from .meta_arch.hybrids import (FCOSNCRetinaNet, FCOSRepPoints, FCOSRetinaNet,
                                PointRetinaNet, RepPointsCenterness,
                                ReppointsRetinaNet, RepPointsV2)
from .meta_arch.rcnn import ProposalVisibleRCNN
from .meta_arch.reppoints import RepPointsDetector
from .meta_arch.retina_rotated import RotatedRetinaNet
from .meta_arch.retinanet import (CenternessRetinaNet, DeformableConvRetinaNet,
                                  NearestRetinaNet, RetinaNet)
from .proposal_generator.ppg import PointsProposalGenerator
from .proposal_generator.rpg import RepPointsGenerator


def _fcos_with_anchor(cfg) -> FCOS:
    """Diagnosis variant: each detection carries its source location as an
    (x, y, x, y) box under ``"anchors"``."""
    return FCOS(cfg, with_anchor=True)


def _retinanet_with_anchor(cfg) -> RetinaNet:
    """Diagnosis variant: each detection carries its anchor through top-k and
    NMS into the outputs."""
    return RetinaNet(cfg, with_anchor=True)


def _rcnn_with_anchor(cfg) -> ProposalVisibleRCNN:
    """Diagnosis variant: each proposal keeps its source anchor and each
    detection its (proposal, anchor) pair."""
    return ProposalVisibleRCNN(cfg, with_anchor=True)


def _proposal_network(cfg) -> nn.Module:
    """ProposalNetwork and ProposalNetworkWithMasks dispatch on
    MODEL.PROPOSAL_GENERATOR.NAME, as the JAX package's registry does: the
    two point-based generators are proposal-only detectors of their own;
    any other name builds ProposalNetworkWithMasks."""
    name = cfg.MODEL.PROPOSAL_GENERATOR.NAME
    if name == "PointsProposalGenerator":
        return PointsProposalGenerator(cfg)
    if name == "RepPointsGenerator":
        return RepPointsGenerator(cfg)
    return ProposalNetworkWithMasks(cfg)


# name -> constructor taking cfg. FCOSV2 is the reference's refactor of FCOS
# with the same topk-then-NMS inference and GroupNet's head is FCOS's line for
# line, so the three names share one class, as in the JAX package; so do
# GeneralizedRCNN and ProposalVisibleRCNN. AblationMetaArch picks its head
# (LRTBHead, LRTBTopkHead, PointSetHead, AnchorHead) by
# MODEL.META_ARCH.NAME. Every name of the JAX package's registry is here.
META_ARCHS = {
    "FCOS": FCOS,
    "FCOSV2": FCOS,
    "GroupNet": FCOS,
    "FCOSWithAnchor": _fcos_with_anchor,
    "FCOSTopK": FCOSTopK,
    "FCOSV3": FCOSV3,
    "FCOSAnchor": FCOSAnchor,
    "FCOSRetinaNet": FCOSRetinaNet,
    "FCOSNCRetinaNet": FCOSNCRetinaNet,
    "RetinaNet": RetinaNet,
    "RetinaNetWithAnchor": _retinanet_with_anchor,
    "CenternessRetinaNet": CenternessRetinaNet,
    "NearestRetinaNet": NearestRetinaNet,
    "PointRetinaNet": PointRetinaNet,
    "DeformableConvRetinaNet": DeformableConvRetinaNet,
    "RotatedRetinaNet": RotatedRetinaNet,
    "ProposalVisibleRCNN": ProposalVisibleRCNN,
    "GeneralizedRCNN": ProposalVisibleRCNN,
    "ProposalVisibleRCNNWithAnchor": _rcnn_with_anchor,
    "RepPointsDetector": RepPointsDetector,
    "RepPointsCenterness": RepPointsCenterness,
    "RepPointsV2": RepPointsV2,
    "FCOSRepPoints": FCOSRepPoints,
    "ReppointsRetinaNet": ReppointsRetinaNet,
    "AblationMetaArch": AblationMetaArch,
    "ProposalNetwork": _proposal_network,
    "ProposalNetworkWithMasks": _proposal_network,
    "CornerNet": CornerNet,
}


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the detector named by cfg.MODEL.META_ARCHITECTURE on ``device``
    with weights drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None). ``device`` None means the card: it raises a RuntimeError
    where there is none, and the CPU is taken only when asked for
    (``device="cpu"``). Unported names raise a KeyError listing the available
    ones. ``TPU.INT8_SCALES``, where set, becomes the process's default
    static int8 scales (``ops.quant.set_default_scales``), as in the JAX
    package, for every predict harness; each conv is named by its Flax path
    (``ops.quant.name_sites``)."""
    if cfg.TPU.INT8_SCALES:
        quant.set_default_scales(quant.load_json_scales(cfg.TPU.INT8_SCALES))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device (torch.cuda.is_available() is "
                "false); pass device=\"cpu\" to build the model on the CPU")
        device = "cuda"
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCHS:
        raise KeyError(f"meta-architecture {name!r} is not ported; "
                       f"available: {sorted(META_ARCHS)}")
    model = META_ARCHS[name](cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.init_weights(generator)
    quant.name_sites(model)
    model.eval()
    return model.to(device=device, memory_format=torch.channels_last)


__all__ = ["META_ARCHS", "build_model"]
