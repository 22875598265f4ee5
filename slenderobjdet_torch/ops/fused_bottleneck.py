"""Fused ResNet bottleneck block (counterpart of
``slenderobjdet_tpu/ops/fused_bottleneck.py``).

- ``reference_bottleneck``: the plain PyTorch version (``F.conv2d``), the
  kernel's oracle.
- ``fused_bottleneck``: a ``torch.autograd.Function`` around the CUDA kernel
  ``csrc/fused_bottleneck.cu``; CPU tensors take ``reference_bottleneck``.
  Its backward is autograd of ``reference_bottleneck`` on the saved inputs,
  as the JAX package's ``custom_vjp`` differentiates the XLA composition.
- ``probe_variant`` / ``reference_probe_variant``: the bisection variants of
  the tensor-core kernel (``PROBE_MODES``) and their plain versions, for
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

# fused_probe_launch's mode codes, in order
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


def _launch(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
    x, weights, cm, cout = _kernel_args("fused_bottleneck", x, w1, b1, w2,
                                        b2, w3, b3, wsc, bsc)
    bsz, h, w, cin = x.shape
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    rc = _build.library().fused_bottleneck_launch(
        _build.dtype_code("fused_bottleneck", x.dtype), *_ptrs(x, weights, out),
        bsz, h, w, cin, cm, cout, _build.stream_ptr(x))
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


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, wsc, bsc):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, wsc, bsc)
        if x.device.type == "cpu":
            return reference_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc, bsc)
        return _launch(x, w1, b1, w2, b2, w3, b3, wsc, bsc)

    @staticmethod
    def backward(ctx, g):
        return reference_grads(reference_bottleneck, ctx.saved_tensors,
                               ctx.needs_input_grad, g)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None):
    """Fused bottleneck forward through the CUDA kernel for CUDA tensors (CPU
    tensors take ``reference_bottleneck``); differentiable, with the
    gradients of ``reference_bottleneck``."""
    return _FusedBottleneck.apply(x, w1, b1, w2, b2, w3, b3, wsc, bsc)


# ------------------------------------------------------------------ probe
def reference_probe_variant(mode, x, w1, b1, w2, b2, w3, b3):
    """Plain version of each probe variant (see ``csrc/fused_bottleneck.cu``,
    ``ProbeMode``): ``full`` is ``reference_bottleneck``; ``norolls`` drops
    the 3x3 conv's column shift (every tap reads a1 at its own column, the
    row shift stays); ``notap`` keeps the centre tap; ``noconv2`` passes a1
    on as a2; ``dmaonly`` is ``x[..., c % cc] * 0.5`` with cc = min(Cin, Cout,
    128); ``nodma`` is ``b + y`` at image b, row y."""
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
    """One bisection variant of the bf16 tensor-core kernel for an identity
    block (``full`` is the very kernel ``fused_bottleneck`` runs) on CUDA
    tensors; CPU tensors take ``reference_probe_variant``."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {PROBE_MODES}")
    if x.device.type == "cpu":
        return reference_probe_variant(mode, x, w1, b1, w2, b2, w3, b3)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"probe_variant: bfloat16 only, got {x.dtype}")
    x, weights, cm, cout = _kernel_args("probe_variant", x, w1, b1, w2, b2,
                                        w3, b3, None, None)
    bsz, h, w, cin = x.shape
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    rc = _build.library().fused_probe_launch(
        PROBE_MODES.index(mode), *_ptrs(x, weights[:6], out), bsz, h, w, cin,
        cm, cout, _build.stream_ptr(x))
    _build.check(rc, f"fused_probe_launch({mode})")
    _build.LAUNCHES["fused_kernel_probe"] += 1
    return out
