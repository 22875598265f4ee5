"""Fused ResNet bottleneck block (counterpart of
``slenderobjdet_tpu/ops/fused_bottleneck.py``).

- ``reference_bottleneck``: the plain PyTorch version (``F.conv2d``), the
  kernels' oracle.
- ``fused_bottleneck``: the registered operator
  ``slenderobjdet::fused_bottleneck`` (the CUDA kernels of
  ``csrc/fused_bottleneck.cu``; CPU tensors take ``reference_bottleneck``),
  inside a ``torch.autograd.Function`` where a gradient is recorded. Its
  backward is autograd of ``reference_bottleneck`` on the saved inputs, as
  the JAX package's ``custom_vjp`` differentiates the XLA composition.
- The host-side plan of a CUDA call: ``bottleneck_plan`` picks the kernel
  by dtype and shape (bf16 blocks with channels in multiples of 64, all of
  R-50's: three wgmma implicit-GEMM launches; the rest: the on-chip block
  on the CUDA cores) and its tiles (``plan_tiles``), and
  ``pack_conv_weights`` lays each conv's weights out as the wgmma kernel's
  shared-memory slots.
- ``probe_variant`` / ``reference_probe_variant``: the bisection variants of
  the wgmma path (``PROBE_MODES``) and their plain versions, for
  ``slenderobjdet_torch/tools/fused_kernel_probe.py``.

Layouts are the JAX package's: x NHWC (B, H, W, Cin); w1 (Cin, Cm),
w2 (3, 3, Cm, Cm) HWIO, w3 (Cm, Cout), wsc (Cin, Cout) or None for the
identity shortcut; biases (C,) float32. Weights are pre-folded (FrozenBN
absorbed) and used in x's dtype. Stride-1, groups-1, dilation-1 blocks only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# the bisection probe's variants
PROBE_MODES = ("full", "norolls", "notap", "noconv2", "dmaonly", "nodma")


def reference_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + shortcut): each conv
    accumulates products of dtype values in fp32, adds its fp32 bias and
    applies relu, then rounds to dtype; an identity shortcut adds x in fp32."""
    dt = x.dtype

    def conv(v, w, pad):          # v NCHW fp32 holding dtype values, w HWIO
        w = w.to(dt).float().permute(3, 2, 0, 1)
        return F.conv2d(v, w, padding=pad)

    def b(v):
        return v.float().view(1, -1, 1, 1)

    xf = x.float().permute(0, 3, 1, 2)
    a1 = torch.relu(conv(xf, w1[None, None], 0) + b(b1)).to(dt).float()
    a2 = torch.relu(conv(a1, w2, 1) + b(b2)).to(dt).float()
    t = conv(a2, w3[None, None], 0) + b(b3)
    sc = xf if wsc is None else conv(xf, wsc[None, None], 0) + b(bsc)
    return torch.relu(t + sc).to(dt).permute(0, 2, 3, 1)


# The kernels' host-side plan. Which kernel a CUDA call runs is decided
# here, by dtype and shape (``bottleneck_plan``), and so are its tiles and
# the weights' layout; ``csrc/fused_bottleneck.cu`` checks what it is given.
SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may opt into
H100_SMS = 132        # streaming multiprocessors of an H100 SXM
GEMM_M = 128          # pixels per tile of the wgmma path (csrc GM)
GEMM_K = 64           # channels per ring slot of the wgmma path (csrc GK)
ONCHIP_TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def onchip_smem_bytes(th, tw, cm, itemsize):
    """Shared memory of the on-chip CUDA-core kernel on a th x tw tile (csrc
    ``smem_bytes``): a1 over the halo tile and a2, plus the staging tiles."""
    p1 = (th + 2) * (tw + 2)
    return (32 * 68 + 32 * 64) * 4 + (p1 + th * tw) * cm * itemsize


def onchip_tile(cm, itemsize, limit=SMEM_LIMIT):
    """The largest tile of ``ONCHIP_TILES`` whose buffers fit in ``limit``."""
    for th, tw in ONCHIP_TILES:
        if onchip_smem_bytes(th, tw, cm, itemsize) <= limit:
            return th, tw
    raise ValueError(f"fused_bottleneck: Cm={cm} does not fit in shared memory")


def conv_tile_n(m_tiles, n, sms=H100_SMS):
    """Output channels per CTA of a wgmma conv: 256 where that still gives
    every SM a tile, else 128, else 64 (n = 64 at res2)."""
    if n % 256 == 0 and m_tiles * (n // 256) >= sms:
        return 256
    return 128 if n % 128 == 0 else 64


def bottleneck_plan(dtype, batch, h, w, cin, cm, cout, aligned=True,
                    sms=H100_SMS):
    """Which kernel runs a CUDA call, and on which tiles.

    - ``wgmma``: 16-byte aligned bf16 blocks with Cin, Cm and Cout % 64 == 0
      (all of R-50's): three implicit-GEMM launches (conv1, conv2, conv3 +
      shortcut) on tiles of 128 consecutive pixels (of the B x H x W
      flattened) by ``bn`` output channels.
    - ``cuda_cores``: everything else, fp32 included: the whole block on
      chip, one launch on th x tw tiles, fp32 FMA.
    """
    if (dtype == torch.bfloat16 and aligned and cin % GEMM_K == 0
            and cm % GEMM_K == 0 and cout % GEMM_K == 0):
        m_tiles = -(-batch * h * w // GEMM_M)
        return {"route": "wgmma", "m_tiles": m_tiles,
                "bn": {"conv1": conv_tile_n(m_tiles, cm, sms),
                       "conv2": conv_tile_n(m_tiles, cm, sms),
                       "conv3": conv_tile_n(m_tiles, cout, sms)}}
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"route": "cuda_cores", "tile": onchip_tile(cm, itemsize)}


def plan_tiles(plan, batch, h, w, cm, cout):
    """The tiles a plan launches, as ``(conv, pixel_slice, channel_slice)``
    over the B x H x W flattened pixels: each conv of the wgmma path, or
    the one on-chip launch (conv ``block``, all output channels)."""
    if plan["route"] == "wgmma":
        m = batch * h * w
        for conv, n in (("conv1", cm), ("conv2", cm), ("conv3", cout)):
            bn = plan["bn"][conv]
            for i in range(plan["m_tiles"]):
                for j in range(n // bn):
                    yield conv, slice(i * GEMM_M, min((i + 1) * GEMM_M, m)), \
                        slice(j * bn, (j + 1) * bn)
        return
    th, tw = plan["tile"]
    for b in range(batch):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                for y in range(y0, min(y0 + th, h)):
                    base = (b * h + y) * w
                    yield "block", slice(base + x0, base + min(x0 + tw, w)), \
                        slice(0, cout)


def pack_conv_weights(wk, bn):
    """A (K, N) weight matrix in the wgmma path's shared-memory image,
    contiguous per (N tile of bn, K step of 64): [N / bn][K / 64][k16 slice
    j < 4][n group < bn / 8][k half < 2][8 n][8 k], the no-swizzle K-major
    layout of 8 x 8 core matrices that the kernel's descriptor reads (128 B
    apart along K, 256 B along N)."""
    k, n = wk.shape
    v = wk.reshape(k // 64, 4, 2, 8, n // bn, bn // 8, 8)
    return v.permute(4, 0, 1, 5, 2, 6, 3).contiguous()


def unpack_conv_weights(packed, bn):
    """The (K, N) matrix ``pack_conv_weights`` laid out."""
    nt, ks = packed.shape[:2]
    return packed.permute(1, 2, 4, 6, 0, 3, 5).reshape(ks * 64, nt * bn)


def conv_weight_matrices(w1, w2, w3, wsc=None, mode="full"):
    """The three convs' (K, N) matrices in the K order the kernel walks:
    w1; the 9 taps of w2 (tap = 3 ky + kx, channel fastest), or the centre
    tap alone for the probe's ``notap``; w3 over a2's channels then, for a
    projection, wsc over x's."""
    cm = w2.shape[2]
    k2 = w2[1, 1] if mode == "notap" else w2.reshape(9 * cm, cm)
    k3 = w3 if wsc is None else torch.cat([w3, wsc], 0)
    return w1, k2, k3


def _kernel_args(name, x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    """Check a CUDA call's tensors and lay them out for the C entry points."""
    proj = wsc is not None
    tensors = [x, w1, b1, w2, b2, w3, b3] + ([wsc, bsc] if proj else [])
    _build.require_cuda(name, *tensors)
    _build.dtype_code(name, x.dtype)
    cin = x.shape[3]
    cm, cout = w1.shape[1], w3.shape[1]
    if (w1.shape != (cin, cm) or w2.shape != (3, 3, cm, cm)
            or w3.shape != (cm, cout)
            or (proj and wsc.shape != (cin, cout))
            or (not proj and cin != cout)):
        raise ValueError(f"{name}: inconsistent shapes")
    dt = x.dtype
    x = x.contiguous()
    w1, w2, w3 = (t.to(dt).contiguous() for t in (w1, w2, w3))
    b1, b2, b3 = (t.float().contiguous() for t in (b1, b2, b3))
    if proj:
        wsc, bsc = wsc.to(dt).contiguous(), bsc.float().contiguous()
    return x, (w1, b1, w2, b2, w3, b3, wsc, bsc), cm, cout


def _ptrs(x, weights, out):
    return ([x.data_ptr()]
            + [None if t is None else t.data_ptr() for t in weights]
            + [out.data_ptr()])


def _plan(x, weights, cm, cout):
    bsz, h, w, cin = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *weights)
                  if t is not None)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return bottleneck_plan(x.dtype, bsz, h, w, cin, cm, cout, aligned, sms)


# ConvMode codes of conv_wgmma_launch
_CONV_MODES = {"full": 0, "norolls": 1, "dmaonly": 2, "nodma": 3}


def _conv(mode, a0, taps, a1, wk, bn, bias0, bias1, res, out):
    """One conv_wgmma_launch: out = relu(A @ wk + bias0 [+ bias1] [+ res])."""
    bsz, h, w, n = out.shape
    packed = None if wk is None else pack_conv_weights(wk, bn)
    rc = _build.library().conv_wgmma_launch(
        _CONV_MODES[mode], a0.data_ptr(), a0.shape[3], taps,
        None if a1 is None else a1.data_ptr(), 0 if a1 is None else a1.shape[3],
        None if packed is None else packed.data_ptr(), bias0.data_ptr(),
        None if bias1 is None else bias1.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(),
        bsz, h, w, n, bn, _build.stream_ptr(out))
    _build.check(rc, f"conv_wgmma_launch({mode})")


def _wgmma_block(plan, x, weights, mode="full"):
    """The wgmma path: conv1, conv2, conv3 + shortcut as three launches,
    a1 and a2 in device memory. ``mode`` is a probe variant (see
    ``reference_probe_variant``); ``full`` is the model's block."""
    w1, b1, w2, b2, w3, b3, wsc, bsc = weights
    bsz, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    if mode in ("dmaonly", "nodma"):
        _conv(mode, x, 1, None, None, 128, b3, None, None, out)
        return out
    bn = plan["bn"]
    k1, k2, k3 = conv_weight_matrices(w1, w2, w3, wsc, mode)
    a1 = torch.empty((bsz, h, w, cm), dtype=x.dtype, device=x.device)
    _conv("full", x, 1, None, k1, bn["conv1"], b1, None, None, a1)
    if mode == "noconv2":
        a2 = a1
    else:
        a2 = torch.empty_like(a1)
        _conv("norolls" if mode == "norolls" else "full", a1,
              1 if mode == "notap" else 9, None, k2, bn["conv2"], b2, None,
              None, a2)
    _conv("full", a2, 1, x if wsc is not None else None, k3, bn["conv3"], b3,
          bsc, x if wsc is None else None, out)
    return out


def _launch(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    x, weights, cm, cout = _kernel_args("fused_bottleneck", x, w1, b1, w2,
                                        b2, w3, b3, wsc, bsc)
    plan = _plan(x, weights, cm, cout)
    if plan["route"] == "wgmma":
        out = _wgmma_block(plan, x, weights)
    else:
        bsz, h, w, cin = x.shape
        out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
        rc = _build.library().fused_bottleneck_launch(
            _build.dtype_code("fused_bottleneck", x.dtype),
            *_ptrs(x, weights, out), bsz, h, w, cin, cm, cout, *plan["tile"],
            _build.stream_ptr(x))
        _build.check(rc, "fused_bottleneck_launch")
    _build.LAUNCHES["fused_bottleneck"] += 1
    return out


def reference_grads(reference, saved, needs, g):
    """Autograd of ``reference`` at the saved inputs: the gradients of the
    inputs in ``needs``, None for the others."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, needs)]
        out = reference(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


# The block as a registered operator, which ``torch.export`` records as one
# node: ``reference_bottleneck`` on CPU tensors, the kernels on CUDA tensors
# (which raise where the build or a launch fails). The weights' re-layout
# (``pack_conv_weights``) runs inside the CUDA implementation, so an exported
# program carries the weights as the model holds them.
@torch.library.custom_op(
    "slenderobjdet::fused_bottleneck", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
           "Tensor b3, Tensor? wsc, Tensor? bsc) -> Tensor")
def _bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    return reference_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc, bsc)


@_bottleneck_plain.register_kernel("cuda")
def _bottleneck_kernel(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    return _launch(x, w1, b1, w2, b2, w3, b3, wsc, bsc)


@_bottleneck_plain.register_fake
def _bottleneck_fake(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    bsz, h, w, _ = x.shape
    return x.new_empty((bsz, h, w, w3.shape[1]))     # NHWC, as both write it


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, wsc, bsc):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, wsc, bsc)
        return torch.ops.slenderobjdet.fused_bottleneck(x, w1, b1, w2, b2, w3, b3,
                                                        wsc, bsc)

    @staticmethod
    def backward(ctx, g):
        return reference_grads(reference_bottleneck, ctx.saved_tensors,
                               ctx.needs_input_grad, g)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None):
    """Fused bottleneck forward through the CUDA kernel for CUDA tensors (CPU
    tensors take ``reference_bottleneck``); differentiable, with the
    gradients of ``reference_bottleneck``. Where no gradient is recorded it
    calls the operator ``slenderobjdet::fused_bottleneck`` directly, as an
    exported program does."""
    args = (x, w1, b1, w2, b2, w3, b3, wsc, bsc)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _FusedBottleneck.apply(*args)
    return torch.ops.slenderobjdet.fused_bottleneck(*args)


# ------------------------------------------------------------------ probe
def reference_probe_variant(mode, x, w1, b1, w2, b2, w3, b3):
    """Plain version of each probe variant (see ``probe_variant`` and
    ``csrc/fused_bottleneck.cu``, ``ConvMode``): ``full`` is
    ``reference_bottleneck``; ``norolls`` drops the 3x3 conv's column shift
    (every tap reads a1 at its own column, the row shift stays); ``notap``
    keeps the centre tap; ``noconv2`` passes a1 on as a2; ``dmaonly`` is
    ``x[..., c % cc] * 0.5`` with cc = min(Cin, Cout, 128); ``nodma`` is
    ``b + y`` at image b, row y."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {PROBE_MODES}")
    dt = x.dtype
    bsz, h, w, cin = x.shape
    cout = w3.shape[1]
    if mode == "full":
        return reference_bottleneck(x, w1, b1, w2, b2, w3, b3)
    if mode == "nodma":
        v = (torch.arange(bsz, device=x.device)[:, None]
             + torch.arange(h, device=x.device)[None, :]).float().to(dt)
        return v[:, :, None, None].expand(bsz, h, w, cout).contiguous()
    if mode == "dmaonly":
        cc = min(cin, cout, 128)
        idx = torch.arange(cout, device=x.device) % cc
        return (x[..., idx].float() * 0.5).to(dt)

    def mm(v, wt):                  # v (..., K) holding dtype values
        return v.float() @ wt.to(dt).float()

    a1 = torch.relu(mm(x, w1) + b1.float()).to(dt)
    if mode == "noconv2":
        a2 = a1
    elif mode == "notap":
        a2 = torch.relu(mm(a1, w2[1, 1]) + b2.float()).to(dt)
    else:                           # norolls: a (3, 1) conv of kx-summed taps
        wk = w2.to(dt).float().sum(1, keepdim=True).permute(3, 2, 0, 1)
        t2 = F.conv2d(a1.float().permute(0, 3, 1, 2), wk, padding=(1, 0))
        a2 = torch.relu(t2.permute(0, 2, 3, 1) + b2.float()).to(dt)
    return torch.relu(mm(a2, w3) + b3.float() + x.float()).to(dt)


def probe_variant(mode, x, w1, b1, w2, b2, w3, b3):
    """One bisection variant of the wgmma path, for an identity block on
    CUDA tensors (``full`` is the very launches ``fused_bottleneck`` makes):
    ``norolls``, ``dmaonly`` and ``nodma`` are modes of the kernel,
    ``notap`` runs conv2 on the centre tap's weights alone and ``noconv2``
    passes a1 to conv3. CPU tensors take ``reference_probe_variant``."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {PROBE_MODES}")
    if x.device.type == "cpu":
        return reference_probe_variant(mode, x, w1, b1, w2, b2, w3, b3)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"probe_variant: bfloat16 only, got {x.dtype}")
    x, weights, cm, cout = _kernel_args("probe_variant", x, w1, b1, w2, b2,
                                        w3, b3, None, None)
    plan = _plan(x, weights, cm, cout)
    if plan["route"] != "wgmma":
        raise ValueError("probe_variant: the block takes no wgmma kernel")
    out = _wgmma_block(plan, x, weights, mode)
    _build.LAUNCHES["fused_kernel_probe"] += 1
    return out
