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
raises). ``model_forward`` and ``model_backward`` are CPU models of the two
kernels' decompositions (bands and look-back carries, row segments, line
walks with deferred credit), on no path: the tests hold them to the plain
versions.

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


def _take(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The running max's step, ``torch.cummax``'s rule: v when v >= m or v is
    NaN, else m (m folds what came earlier in scan order, v what came later)."""
    return torch.where((v >= m) | torch.isnan(v), v, m)


def _scan_order(corner: str, *tensors: torch.Tensor):
    """The tensors with H and W flipped for ``tl`` (whose scans run from the
    bottom and the right), so that scan order is ascending; the same call
    maps back."""
    return [t.flip((2, 3)) if corner == "tl" else t for t in tensors]


def model_forward(a: torch.Tensor, b: torch.Tensor, corner: str, rows: int, seg: int,
                  chunk: int, gen=None) -> torch.Tensor:
    """A CPU model of the forward kernel's decomposition (not on any path):
    channels in chunks of ``chunk``; per chunk, bands of ``rows`` rows in
    scan order, each band's carry found by looking back over the bands
    before it, taking a band's inclusive maxima (which ends the walk) or
    its aggregate (which does not), as ``gen`` (a ``numpy`` generator;
    band 0 is always inclusive) decides, where the kernel's timing does;
    then the vertical walk from the carry; each row scanned in segments of
    ``seg`` positions: segment maxima, the fold of the segments before,
    the segment again; the sum formed in fp32 and rounded once. Equal to
    ``plain_tl_pool`` / ``plain_br_pool`` bit for bit."""
    a, b = _scan_order(corner, a, b)
    B, C, H, W = a.shape
    neg = torch.full((B, C, W), float("-inf"), dtype=a.dtype)
    vert = torch.empty_like(a)
    for c0 in range(0, C, chunk):
        cs = slice(c0, c0 + chunk)
        aggs, incls = [], []
        for s0 in range(0, H, rows):
            band = range(s0, min(H, s0 + rows))
            agg = neg[:, cs]
            for s in band:
                agg = _take(agg, a[:, cs, s])
            carry = neg[:, cs]
            for j in range(len(aggs) - 1, -1, -1):
                inclusive = j == 0 or gen is None or bool(gen.integers(2))
                carry = _take(incls[j] if inclusive else aggs[j], carry)
                if inclusive:
                    break
            for s in band:
                carry = _take(carry, a[:, cs, s])
                vert[:, cs, s] = carry
            aggs.append(agg)
            incls.append(carry)
    horiz = torch.empty_like(b)
    neg = torch.full((B, C, H), float("-inf"), dtype=a.dtype)
    starts = range(0, W, seg)
    seg_max = []
    for p0 in starts:
        m = neg
        for p in range(p0, min(W, p0 + seg)):
            m = _take(m, b[..., p])
        seg_max.append(m)
    for i, p0 in enumerate(starts):
        h = neg
        for m in seg_max[:i]:
            h = _take(h, m)
        for p in range(p0, min(W, p0 + seg)):
            h = _take(h, b[..., p])
            horiz[..., p] = h
    out = (vert.float() + horiz.float()).to(a.dtype)
    return _scan_order(corner, out)[0]


def _line_gradient(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's walk along the last dimension of every line at
    once: each position gets 0; when the running argmax moves, the fp32 sum
    of g since it last moved goes to the old argmax; the last argmax gets
    the last sum; each sum rounded once to x's dtype."""
    n = x.shape[-1]
    xs, gs = x.reshape(-1, n), g.reshape(-1, n).float()
    lines = torch.arange(xs.shape[0])
    m = torch.full((xs.shape[0],), float("-inf"), dtype=x.dtype)
    arg = torch.full((xs.shape[0],), -1, dtype=torch.long)
    acc = torch.zeros(xs.shape[0])
    out = torch.zeros(xs.shape)
    for i in range(n):
        v = xs[:, i]
        moved = (v >= m) | torch.isnan(v)
        close = moved & (arg >= 0)
        out[lines[close], arg[close]] = acc[close]
        m = torch.where(moved, v, m)
        arg = torch.where(moved, torch.full_like(arg, i), arg)
        acc = torch.where(moved, torch.zeros_like(acc), acc) + gs[:, i]
    out[lines, arg] = acc
    return out.to(x.dtype).reshape(x.shape)


def model_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, corner: str):
    """A CPU model of the backward kernel (not on any path): a walk a line,
    the columns of a with g for ``g_a`` and the rows of b with g for
    ``g_b``, in scan order (``_line_gradient``)."""
    a, b, g = _scan_order(corner, a, b, g)
    ga = _line_gradient(a.transpose(2, 3), g.transpose(2, 3)).transpose(2, 3)
    gb = _line_gradient(b, g)
    return _scan_order(corner, ga, gb)


def _checked(name: str, *tensors: torch.Tensor):
    """The tensors channels last (NHWC memory), after checking they are CUDA
    tensors of one shape and one supported dtype. A tensor already channels
    last is returned as it is, with no copy."""
    _build.require_cuda(name, *tensors)
    shape, dtype = tensors[0].shape, tensors[0].dtype
    if len(shape) != 4 or any(t.shape != shape or t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: tensors {[tuple(t.shape) for t in tensors]} of "
                         f"{[t.dtype for t in tensors]}, expected one (B, C, H, W) shape "
                         f"and dtype")
    return [t.contiguous(memory_format=torch.channels_last) for t in tensors]


def forward_scratch(a: torch.Tensor) -> torch.Tensor:
    """The forward kernel's scratch for inputs like ``a``: the band slots,
    their flags and the ticket (zeroed by each launch)."""
    n = _build.library().corner_pool_forward_scratch_bytes(
        _build.dtype_code("corner_pool", a.dtype), *a.shape)
    if n < 0:
        raise ValueError(f"corner_pool: W={a.shape[3]} is too wide for the kernel "
                         f"(at most about 3,500 columns)")
    return torch.empty(n, dtype=torch.uint8, device=a.device)


def forward_into(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, scratch: torch.Tensor,
                 corner: str) -> None:
    """The forward kernel alone on checked channels-last tensors: no check,
    allocation or launch count (the wrapper's part)."""
    B, C, H, W = a.shape
    rc = _build.library().corner_pool_forward_launch(
        _build.dtype_code("corner_pool", a.dtype), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, C, H, W, CORNERS[corner], _build.stream_ptr(a))
    _build.check(rc, "corner_pool_forward_launch")


def backward_into(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, ga: torch.Tensor,
                  gb: torch.Tensor, corner: str) -> None:
    """The backward kernel alone on checked channels-last tensors."""
    B, C, H, W = a.shape
    rc = _build.library().corner_pool_backward_launch(
        _build.dtype_code("corner_pool", a.dtype), a.data_ptr(), b.data_ptr(), g.data_ptr(),
        ga.data_ptr(), gb.data_ptr(), B, C, H, W, CORNERS[corner], _build.stream_ptr(a))
    _build.check(rc, "corner_pool_backward_launch")


def launch_corner_pool(a: torch.Tensor, b: torch.Tensor, corner: str) -> torch.Tensor:
    """One forward call of the kernel (one launch, after zeroing its
    flags): ``a``, ``b`` (B, C, H, W) CUDA tensors, float32 or bfloat16;
    the output is channels last."""
    a, b = _checked("corner_pool", a, b)
    out = torch.empty_like(a, memory_format=torch.channels_last)
    forward_into(a, b, out, forward_scratch(a), corner)
    _build.LAUNCHES["corner_pool"] += 1
    return out


def launch_corner_pool_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                                corner: str):
    """One backward call of the kernel (one launch): the gradients of ``a``
    and ``b`` from the output's gradient ``g``, channels last."""
    a, b, g = _checked("corner_pool_backward", a, b, g.to(a.dtype))
    ga = torch.empty_like(a, memory_format=torch.channels_last)
    gb = torch.empty_like(b, memory_format=torch.channels_last)
    backward_into(a, b, g, ga, gb, corner)
    _build.LAUNCHES["corner_pool"] += 1
    return ga, gb


# The forward as a registered operator, which ``torch.export`` records as
# one node: the plain version on CPU tensors, the kernel on CUDA tensors
# (which raises where the build or the launch fails).
@torch.library.custom_op("slenderobjdet::corner_pool", mutates_args=(), device_types="cpu",
                         schema="(Tensor a, Tensor b, str corner) -> Tensor")
def _pool_plain(a, b, corner):
    return (plain_tl_pool if corner == "tl" else plain_br_pool)(a, b)


@_pool_plain.register_kernel("cuda")
def _pool_kernel(a, b, corner):
    return launch_corner_pool(a, b, corner)


@_pool_plain.register_fake
def _pool_fake(a, b, corner):
    if a.device.type == "cuda":         # the kernel writes channels last
        return torch.empty_like(a, memory_format=torch.channels_last)
    return torch.empty_like(a)


class _CornerPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, corner):
        ctx.corner = corner
        ctx.save_for_backward(a, b)
        return torch.ops.slenderobjdet.corner_pool(a, b, corner)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = launch_corner_pool_backward(a, b, g, ctx.corner)
        return ga, gb, None


def _pool(a: torch.Tensor, b: torch.Tensor, corner: str) -> torch.Tensor:
    """Where a gradient is recorded, the plain composition on CPU tensors and
    the kernels' ``autograd.Function`` on CUDA tensors; otherwise the
    operator ``slenderobjdet::corner_pool``, as an exported program calls it."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if a.device.type == "cpu":
            return (plain_tl_pool if corner == "tl" else plain_br_pool)(a, b)
        return _CornerPool.apply(a, b, corner)
    return torch.ops.slenderobjdet.corner_pool(a, b, corner)


def tl_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Top-left corner pooling, ``top_pool(a) + left_pool(b)``: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    return _pool(a, b, "tl")


def br_pool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bottom-right corner pooling, ``bottom_pool(a) + right_pool(b)``."""
    return _pool(a, b, "br")
