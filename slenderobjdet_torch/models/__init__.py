"""Config-driven model construction (counterpart of
``slenderobjdet_tpu/models/__init__.py:build_model``)."""

from __future__ import annotations

from typing import Optional

import torch

from .meta_arch.fcos import FCOS

# FCOSV2 is the reference's refactor of FCOS with the same topk-then-NMS
# inference, so the two names share one class, as in the JAX package.
META_ARCHS = {"FCOS": FCOS, "FCOSV2": FCOS}


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None) -> FCOS:
    """Build the detector named by cfg.MODEL.META_ARCHITECTURE on ``device``
    with weights drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None). ``device`` None means the card: it raises a RuntimeError
    where there is none, and the CPU is taken only when asked for
    (``device="cpu"``). Unported names raise a KeyError listing the available
    ones."""
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
    model.eval()
    return model.to(device=device, memory_format=torch.channels_last)


__all__ = ["META_ARCHS", "build_model"]
