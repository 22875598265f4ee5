"""Copy-bandwidth probe ``y = x * 0.5`` (counterpart of
``tools/pallas_bw_probe.py``'s Pallas kernel).

- ``reference_copy``: the plain PyTorch version, ``x * 0.5`` (the TPU
  probe's ``xlacopy``).
- ``bw_copy``: the wrapper of ``csrc/bw_probe.cu`` in one of ``MODES``
  (``blocked``: full-row 16-byte vectors; ``chunked``: 128-channel store
  slices); CPU tensors take ``reference_copy``.

x is (B, H, W, C) bfloat16 NHWC, copied by one block per (image, th rows).
"""

from __future__ import annotations

import torch

from . import _build

MODES = ("blocked", "chunked")


def reference_copy(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5


def bw_copy(x: torch.Tensor, th: int, mode: str) -> torch.Tensor:
    """``x * 0.5`` through the CUDA kernel for CUDA tensors, bit-exact with
    ``reference_copy``; CPU tensors take ``reference_copy``."""
    if mode not in MODES:
        raise ValueError(f"bw_copy: mode {mode!r} not in {MODES}")
    if x.device.type == "cpu":
        return reference_copy(x)
    _build.require_cuda("bw_copy", x)
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 or th < 1:
        raise ValueError(f"bw_copy: needs bfloat16 x with C % 8 == 0 and "
                         f"th >= 1; got {x.dtype} {tuple(x.shape)}, th {th}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rc = _build.library().bw_probe_launch(
        MODES.index(mode), x.data_ptr(), y.data_ptr(), b, h, w, c, th,
        _build.stream_ptr(x))
    _build.check(rc, f"bw_probe_launch({mode})")
    _build.LAUNCHES["bw_probe"] += 1
    return y
