"""Fused ResNet stem: 7x7/2 conv + FrozenBN affine + relu + 3x3/2 max-pool
(counterpart of ``slenderobjdet_tpu/ops/fused_stem.py``).

- ``reference_stem``: the plain PyTorch version (``F.conv2d`` +
  ``F.max_pool2d``), the kernel's oracle.
- ``fused_stem``: the registered operator ``slenderobjdet::fused_stem``
  (the CUDA kernels of ``csrc/fused_stem.cu``; CPU tensors take
  ``reference_stem``), inside a ``torch.autograd.Function`` where a
  gradient is recorded. Its backward is autograd of ``reference_stem`` on
  the saved inputs, as the JAX package's ``custom_vjp`` differentiates the
  XLA composition.
- ``stem_eligible``: the static gate the backbone checks.
- The host-side plan of a CUDA call: ``stem_plan`` picks the kernel by dtype
  and width (bf16 with 64 output channels, every ResNet's stem: the
  tensor-core kernel on a persistent grid; float32 and other widths: the
  CUDA-core kernel) and ``stem_tiles`` lists its tiles;
  ``pack_stem_weights`` folds, rounds and lays the weights out as the
  tensor-core kernel's B fragments over its padded K.

Layouts are the JAX package's: x NHWC (B, H, W, 3), w HWIO (7, 7, 3, Cs),
output (B, H/4, W/4, Cs) in x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_bottleneck import H100_SMS, reference_grads

# The tensor-core kernel's GEMM (csrc/fused_stem.cu, namespace tc): K walks
# 7 ky groups of 24 slots, slot 1 + 3 kx + ci holding tap (ky, kx, ci) and
# slots 0, 22 and 23 zeros, padded to 11 steps of 16.
MMA_CS = 64                  # output channels the tensor-core kernel takes
MMA_TILE = (8, 16)           # its tile of pooled pixels (csrc TP, TQ)
MMA_K_SLOTS = 24
MMA_K = 176
CUDA_CORE_TILE = (4, 8)      # the CUDA-core kernel's tile (csrc cc::TP, TQ)


def stem_eligible(x_shape, w_shape) -> bool:
    """3 input channels, a 7x7 kernel, and H and W divisible by 4."""
    _, h, w, cin = x_shape
    return cin == 3 and tuple(w_shape[:3]) == (7, 7, 3) and h % 4 == 0 \
        and w % 4 == 0


def _fold(w: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    """FrozenBN scale folded into the weights and rounded to dtype."""
    return (w.float() * scale.float()).to(dtype)


def reference_stem(x, w, scale, bias):
    """relu(conv7x7/2(x, w * scale) + bias) -> maxpool 3x3/2, with fp32
    accumulation of dtype products, the bias added in fp32 and the relu output
    rounded to dtype before the pool."""
    wf = _fold(w, scale, x.dtype).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wf, stride=2, padding=3)
    y = torch.relu(y + bias.float().view(1, -1, 1, 1)).to(x.dtype)
    # max commutes with the rounding above, so pooling in fp32 is exact
    y = F.max_pool2d(y.float(), 3, stride=2, padding=1).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def stem_plan(dtype, batch, h, w, cs, sms=H100_SMS):
    """Which kernel runs a CUDA call, and on which tiles.

    - ``mma``: bf16 with 64 output channels: the tensor-core kernel, ``grid``
      persistent CTAs (one an SM) walking the B x ceil(Hp / 8) x
      ceil(Wp / 16) tiles, CTA c taking tiles c, c + grid, ... (x must be
      8-byte aligned, or the launch fails).
    - ``cuda_cores``: float32, and bf16 at other widths: fp32 FMA, one block
      per 4 x 8 tile.
    """
    if dtype == torch.bfloat16 and cs == MMA_CS:
        route, tile = "mma", MMA_TILE
    else:
        route, tile = "cuda_cores", CUDA_CORE_TILE
    tiles = batch * -(-(h // 4) // tile[0]) * -(-(w // 4) // tile[1])
    return {"route": route, "tile": tile, "tiles": tiles,
            "grid": min(tiles, sms) if route == "mma" else tiles}


def stem_tiles(plan, batch, h, w):
    """The tiles a plan launches, as ``(cta, image, row_slice, col_slice)``
    over the (H / 4, W / 4) pooled map, in the kernels' order (columns
    fastest)."""
    tp, tq = plan["tile"]
    hp, wp = h // 4, w // 4
    index = 0
    for b in range(batch):
        for p0 in range(0, hp, tp):
            for q0 in range(0, wp, tq):
                yield index % plan["grid"], b, slice(p0, min(p0 + tp, hp)), \
                    slice(q0, min(q0 + tq, wp))
                index += 1


def stem_weight_matrix(wf):
    """Folded HWIO weights (7, 7, 3, Cs) as the tensor-core kernel's (176,
    Cs) B matrix: row 24 ky + 1 + 3 kx + ci, zeros elsewhere."""
    cs = wf.shape[-1]
    m = wf.new_zeros(MMA_K, cs)
    m[:7 * MMA_K_SLOTS].view(7, MMA_K_SLOTS, cs)[:, 1:22] = wf.reshape(7, 21, cs)
    return m


def pack_stem_weights(w, scale):
    """The folded bf16 weights in the order the tensor-core kernel reads
    them: [k16 step < 11][n8 tile pair < Cs / 16][lane < 32][4 registers][2],
    where lane 4 g + t's register 2 n2 + h of pair q holds rows 16 s + 8 h +
    2 t (+ 1) of column 8 (2 q + n2) + g (the ``mma.m16n8k16`` B fragment)."""
    wk = stem_weight_matrix(_fold(w, scale, torch.bfloat16))
    cs = wk.shape[1]
    v = wk.reshape(MMA_K // 16, 2, 4, 2, cs // 16, 2, 8)    # s h t e q n2 g
    return v.permute(0, 4, 6, 2, 5, 1, 3).reshape(
        MMA_K // 16, cs // 16, 32, 4, 2).contiguous()


def unpack_stem_weights(packed):
    """The folded HWIO (7, 7, 3, Cs) weights ``pack_stem_weights`` laid out."""
    steps, pairs = packed.shape[:2]
    v = packed.reshape(steps, pairs, 8, 4, 2, 2, 2)         # s q g t n2 h e
    wk = v.permute(0, 5, 3, 6, 1, 4, 2).reshape(steps * 16, pairs * 16)
    m = wk[:7 * MMA_K_SLOTS].reshape(7, MMA_K_SLOTS, pairs * 16)
    return m[:, 1:22].reshape(7, 7, 3, pairs * 16)


def launch_stem(x, w, scale, bias, route=None):
    """One counted launch of the kernel ``stem_plan`` names (or of ``route``,
    for a timing of one kernel beside the other)."""
    _build.require_cuda("fused_stem", x, w, scale, bias)
    code = _build.dtype_code("fused_stem", x.dtype)
    b, h, wd, _ = x.shape
    if not stem_eligible(x.shape, w.shape):
        raise ValueError(f"fused_stem: ineligible shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    cs = w.shape[-1]
    x = x.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = stem_plan(x.dtype, b, h, wd, cs, sms)
    if route not in (None, plan["route"], "cuda_cores"):
        raise ValueError(f"fused_stem: route {route!r} does not take "
                         f"{x.dtype} x with {cs} output channels")
    route = route or plan["route"]
    lib = _build.library()
    bias = bias.float().contiguous()
    out = torch.empty((b, h // 4, wd // 4, cs), dtype=x.dtype, device=x.device)
    if route == "mma":
        packed = pack_stem_weights(w, scale)
        rc = lib.fused_stem_mma_launch(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, plan["grid"], _build.stream_ptr(x))
        _build.check(rc, "fused_stem_mma_launch")
    else:
        if lib.fused_stem_cuda_core_smem_bytes(cs) > \
                torch.cuda.get_device_properties(
                    x.device).shared_memory_per_block_optin:
            raise ValueError(f"fused_stem: {cs} output channels do not fit "
                             f"in shared memory")
        wf = _fold(w, scale, x.dtype).float().contiguous()
        rc = lib.fused_stem_cuda_core_launch(
            code, x.data_ptr(), wf.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, wd, cs, _build.stream_ptr(x))
        _build.check(rc, "fused_stem_cuda_core_launch")
    _build.LAUNCHES["fused_stem"] += 1
    return out


# The stem as a registered operator, which ``torch.export`` records as one
# node: ``reference_stem`` on CPU tensors, the kernel on CUDA tensors (which
# raises where the build or the launch fails). The weights are folded and
# laid out inside the CUDA implementation.
@torch.library.custom_op("slenderobjdet::fused_stem", mutates_args=(),
                         device_types="cpu",
                         schema="(Tensor x, Tensor w, Tensor scale, Tensor bias) -> Tensor")
def _stem_plain(x, w, scale, bias):
    return reference_stem(x, w, scale, bias)


@_stem_plain.register_kernel("cuda")
def _stem_kernel(x, w, scale, bias):
    return launch_stem(x, w, scale, bias)


@_stem_plain.register_fake
def _stem_fake(x, w, scale, bias):
    b, h, wd, _ = x.shape
    return x.new_empty((b, h // 4, wd // 4, w.shape[-1]))     # NHWC, as both write it


class _FusedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return torch.ops.slenderobjdet.fused_stem(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        return reference_grads(reference_stem, ctx.saved_tensors,
                               ctx.needs_input_grad, g)


def fused_stem(x, w, scale, bias):
    """Fused stem forward through the CUDA kernel for CUDA tensors (CPU
    tensors take ``reference_stem``); differentiable, with the gradients of
    ``reference_stem``. Where no gradient is recorded it calls the operator
    ``slenderobjdet::fused_stem`` directly, as an exported program does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, scale, bias)):
        return _FusedStem.apply(x, w, scale, bias)
    return torch.ops.slenderobjdet.fused_stem(x, w, scale, bias)
