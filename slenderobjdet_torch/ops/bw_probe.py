"""Copy-bandwidth probe ``y = x * 0.5`` (counterpart of
``tools/pallas_bw_probe.py``'s Pallas kernel).

- ``reference_copy``: the plain PyTorch version, ``x * 0.5`` (the TPU
  probe's ``xlacopy``).
- ``bw_copy``: the wrapper of ``csrc/bw_probe.cu`` in one of ``MODES``
  (``blocked``: a chunk leaves as it came, by one bulk copy; ``chunked``:
  16-byte vector stores in 128-channel slices); CPU tensors take
  ``reference_copy``.
- ``copy_chunks``: the kernel's grid, on the host: which 16-byte vectors
  each CTA moves, in which order.

x is (B, H, W, C) bfloat16 NHWC. ``th`` is the block of rows moved as one
unit: each (image, th rows) block is cut into chunks of at most
``CHUNK_BYTES``, and the grid is one CTA a chunk, so ``th`` does not decide
how many SMs work.
"""

from __future__ import annotations

import torch

from . import _build

MODES = ("blocked", "chunked")
CHUNK_BYTES = 16 * 1024     # the most one CTA moves (csrc kChunk)
SLICE_VECTORS = 16          # 128 channels, the chunked mode's store slice


def reference_copy(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5


def chunk_bytes(c: int) -> int:
    """A full chunk at C channels: whole pixels, at most ``CHUNK_BYTES``."""
    return CHUNK_BYTES // (2 * c) * (2 * c)


def copy_chunks(shape, th: int, mode: str):
    """The chunks of a ``bw_copy`` call, one a CTA, in the grid's (image,
    th-row block, chunk) order: each the indices of the 16-byte vectors of x
    the chunk holds, in the order they are stored. ``blocked`` walks a chunk
    front to back, ``chunked`` in 128-channel slices (slice c0 of every
    pixel, then the next slice)."""
    b, h, w, c = shape
    row, chunk, cv = w * c * 2, chunk_bytes(c), c // 8
    th = min(th, h)
    for image in range(b):
        for y0 in range(0, h, th):
            start = (image * h + y0) * row
            end = start + min(th, h - y0) * row
            for off in range(start, end, chunk):
                n = (min(off + chunk, end) - off) // 16
                order = torch.arange(n)
                if mode == "chunked":
                    order = torch.cat([
                        (order.view(-1, cv)[:, c0:c0 + SLICE_VECTORS]).reshape(-1)
                        for c0 in range(0, cv, SLICE_VECTORS)])
                yield off // 16 + order


def bw_copy(x: torch.Tensor, th: int, mode: str) -> torch.Tensor:
    """``x * 0.5`` through the CUDA kernel for CUDA tensors, bit-exact with
    ``reference_copy``; CPU tensors take ``reference_copy``."""
    if mode not in MODES:
        raise ValueError(f"bw_copy: mode {mode!r} not in {MODES}")
    if x.device.type == "cpu":
        return reference_copy(x)
    _build.require_cuda("bw_copy", x)
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 or 2 * c > CHUNK_BYTES or th < 1:
        raise ValueError(f"bw_copy: needs bfloat16 x with C % 8 == 0, C <= "
                         f"{CHUNK_BYTES // 2} and th >= 1; got {x.dtype} "
                         f"{tuple(x.shape)}, th {th}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rc = _build.library().bw_probe_launch(
        MODES.index(mode), x.data_ptr(), y.data_ptr(), b, h, w, c, th,
        _build.stream_ptr(x))
    _build.check(rc, f"bw_probe_launch({mode})")
    _build.LAUNCHES["bw_probe"] += 1
    return y
