"""Corner pooling (counterpart of ``slenderobjdet_tpu/ops/corner_pool.py``).

Directions follow the reference's naming, on (B, C, H, W) tensors:

- ``top_pool``:    out(y) = max over y' >= y
- ``bottom_pool``: out(y) = max over y' <= y
- ``left_pool``:   out(x) = max over x' >= x
- ``right_pool``:  out(x) = max over x' <= x

Each is a ``torch.cummax`` composition, flipped for the reverse
directions: the plain version, run on CPU tensors and the oracle of the
kernel. ``tl_pool(a, b) = top_pool(a) + left_pool(b)`` and ``br_pool(a, b)
= bottom_pool(a) + right_pool(b)`` run the CUDA kernel of
``csrc/corner_pool.cu`` on CUDA tensors, through a ``torch.autograd.Function``
whose backward is the kernel's own (no fallback: a failed build or launch
raises).

Ties: the gradient of a running max goes to one element. ``torch.cummax``
and the kernel give it to the element found later in scan order;
autodiff through the JAX package's ``associative_scan(max)`` splits it
between the tied elements. In CornerNet the pooled maps are ReLU outputs,
whose only ties in fp32 are zeros, where ReLU's gradient is 0 either way.
"""

from __future__ import annotations

import torch

from . import _build

CORNERS = {"tl": 0, "br": 1}


def _cummax(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    if reverse:
        return torch.flip(torch.cummax(torch.flip(x, (dim,)), dim).values, (dim,))
    return torch.cummax(x, dim).values


def top_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 2, reverse=True)


def bottom_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 2, reverse=False)


def left_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 3, reverse=True)


def right_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 3, reverse=False)


def plain_tl_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return top_pool(a) + left_pool(b)


def plain_br_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bottom_pool(a) + right_pool(b)


def _checked(name: str, *tensors: torch.Tensor):
    """The tensors channels last (NHWC memory), after checking they are CUDA
    tensors of one shape and one supported dtype."""
    _build.require_cuda(name, *tensors)
    shape, dtype = tensors[0].shape, tensors[0].dtype
    if len(shape) != 4 or any(t.shape != shape or t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: tensors {[tuple(t.shape) for t in tensors]} of "
                         f"{[t.dtype for t in tensors]}, expected one (B, C, H, W) shape "
                         f"and dtype")
    return [t.contiguous(memory_format=torch.channels_last) for t in tensors]


def launch_corner_pool(a: torch.Tensor, b: torch.Tensor, corner: str) -> torch.Tensor:
    """One forward call of the kernel (two launches on the stream): ``a``,
    ``b`` (B, C, H, W) CUDA tensors, float32 or bfloat16; the output is
    channels last."""
    a, b = _checked("corner_pool", a, b)
    out = torch.empty_like(a, memory_format=torch.channels_last)
    B, C, H, W = a.shape
    rc = _build.library().corner_pool_forward_launch(
        _build.dtype_code("corner_pool", a.dtype), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), B, C, H, W, CORNERS[corner], _build.stream_ptr(a))
    _build.check(rc, "corner_pool_forward_launch")
    _build.LAUNCHES["corner_pool"] += 1
    return out


def launch_corner_pool_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                                corner: str):
    """One backward call of the kernel (two launches): the gradients of
    ``a`` and ``b`` from the output's gradient ``g``, channels last."""
    a, b, g = _checked("corner_pool_backward", a, b, g.to(a.dtype))
    ga = torch.empty_like(a, memory_format=torch.channels_last)
    gb = torch.empty_like(b, memory_format=torch.channels_last)
    B, C, H, W = a.shape
    rc = _build.library().corner_pool_backward_launch(
        _build.dtype_code("corner_pool", a.dtype), a.data_ptr(), b.data_ptr(), g.data_ptr(),
        ga.data_ptr(), gb.data_ptr(), B, C, H, W, CORNERS[corner], _build.stream_ptr(a))
    _build.check(rc, "corner_pool_backward_launch")
    _build.LAUNCHES["corner_pool"] += 1
    return ga, gb


class _CornerPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, corner):
        ctx.corner = corner
        ctx.save_for_backward(a, b)
        return launch_corner_pool(a, b, corner)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = launch_corner_pool_backward(a, b, g, ctx.corner)
        return ga, gb, None


def tl_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Top-left corner pooling, ``top_pool(a) + left_pool(b)``: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if a.device.type == "cpu":
        return plain_tl_pool(a, b)
    return _CornerPool.apply(a, b, "tl")


def br_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bottom-right corner pooling, ``bottom_pool(a) + right_pool(b)``."""
    if a.device.type == "cpu":
        return plain_br_pool(a, b)
    return _CornerPool.apply(a, b, "br")
