"""Read-bandwidth probe with the tile copy split into N concurrent copies
(counterpart of ``tools/dma_streams_probe.py``'s Pallas kernel).

- ``reference_dma_streams``: the plain PyTorch version of the token the
  kernel writes.
- ``dma_streams``: the wrapper of ``csrc/dma_streams_probe.cu``; CPU tensors
  take ``reference_dma_streams``.

x is (B, H, W, C) bfloat16 NHWC; block (b, i) reads rows [i * th, (i + 1) *
th) of image b, and the output (B, H // th, 8, 128) float32 holds each
tile's token ``sum(tile[:8, :8, :128], axis=1) * 1e-6``.
"""

from __future__ import annotations

import torch

from . import _build


def reference_dma_streams(x: torch.Tensor, th: int) -> torch.Tensor:
    b, h, _, _ = x.shape
    nh = h // th
    tiles = x[:, :nh * th].reshape(b, nh, th, *x.shape[2:])
    return tiles[:, :, :8, :8, :128].float().sum(3) * 1e-6


def dma_streams(x: torch.Tensor, th: int, nstreams: int) -> torch.Tensor:
    """Every tile of x read through shared memory in chunks of ``nstreams``
    bulk asynchronous copies each, on CUDA tensors; CPU tensors take
    ``reference_dma_streams``."""
    if x.device.type == "cpu":
        return reference_dma_streams(x, th)
    _build.require_cuda("dma_streams", x)
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 or c < 128 or w < 8 \
            or not 8 <= th <= h or nstreams < 1:
        raise ValueError(f"dma_streams: needs bfloat16 x with C % 8 == 0, "
                         f"C >= 128, W >= 8, 8 <= th <= H and nstreams >= 1; "
                         f"got {x.dtype} {tuple(x.shape)}, th {th}, "
                         f"nstreams {nstreams}")
    x = x.contiguous()
    out = torch.empty((b, h // th, 8, 128), dtype=torch.float32,
                      device=x.device)
    rc = _build.library().dma_streams_launch(
        x.data_ptr(), out.data_ptr(), b, h, w, c, th, nstreams,
        _build.stream_ptr(x))
    _build.check(rc, "dma_streams_launch")
    _build.LAUNCHES["dma_streams_probe"] += 1
    return out
