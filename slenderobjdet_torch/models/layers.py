"""Shared building blocks (counterpart of ``slenderobjdet_tpu/models/layers.py``).

Tensors are NCHW (in ``torch.channels_last`` memory inside the backbone);
parameters are float32 and the compute dtype is the input's dtype.

Trainable BatchNorm (``BatchNorm``, ``get_norm("BN" | "SyncBN")``) tells
training from inference by a context, not by ``module.training``: inside
``batch_statistics()`` every ``BatchNorm`` normalises by its batch's
statistics and updates its running ones; outside it, it uses the running
statistics. Every detector's ``loss`` enters the context
(``uses_batch_statistics``), as the JAX package's ``apply_train`` opens the
``buffers`` collection exactly inside a loss; ``predict``, ``forward`` and
``build_model``'s ``.eval()`` leave it closed. In a process group the batch
statistics are reduced over the processes (``parallel.multihost.
sum_over_processes``), so that "BN" and "SyncBN" are one module whose
statistics are those of the global batch, as under the JAX package's
sharded jit. ``precise_bn_stats`` enters the context without the reduction.

``rematerialized`` runs a block whose activations the backward recomputes
(``TPU.REMAT_BACKBONE``, the JAX package's ``nn.remat``): it carries the
forward's statistics mode into the recompute and keeps the recompute from
updating running statistics a second time.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import quant
from ..ops.deform_conv import deform_apply, deform_conv2d_batched, kernel_base_offsets
from ..parallel.multihost import sum_over_processes

# mode None: running statistics; True / False: batch statistics, reduced
# over the process group or not. update False: a recompute, which leaves the
# running statistics as they are.
_BATCH_STATS = threading.local()


@contextlib.contextmanager
def batch_statistics(sync: bool = True):
    """Inside, every ``BatchNorm`` normalises by its batch's statistics and
    updates its running ones; with ``sync``, the statistics are those of the
    batch joined over the process group."""
    prev = getattr(_BATCH_STATS, "mode", None)
    _BATCH_STATS.mode = sync
    try:
        yield
    finally:
        _BATCH_STATS.mode = prev


@contextlib.contextmanager
def _statistics_state(mode, update: bool):
    prev = (getattr(_BATCH_STATS, "mode", None), getattr(_BATCH_STATS, "update", True))
    _BATCH_STATS.mode, _BATCH_STATS.update = mode, update
    try:
        yield
    finally:
        _BATCH_STATS.mode, _BATCH_STATS.update = prev


def rematerialized(fn, *args):
    """``fn(*args)``, whose activations autograd recomputes in the backward
    instead of storing them (``torch.utils.checkpoint``, non-reentrant); a
    plain call where no gradient is recorded.

    The recompute runs when the backward reaches it: after ``loss`` has left
    ``batch_statistics()``, and on CUDA in autograd's own thread. So the
    statistics mode of the forward is captured here and set around both
    runs, and only the first run updates the running statistics: the
    recompute normalises by the same batch statistics and counts nothing
    twice."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mode = getattr(_BATCH_STATS, "mode", None)
    runs = []

    def run(*inner):
        with _statistics_state(mode, update=not runs):
            runs.append(None)
            return fn(*inner)

    return checkpoint(run, *args, use_reentrant=False)


def uses_batch_statistics(loss):
    """Decorates a detector's ``loss``: it runs inside ``batch_statistics()``."""
    @functools.wraps(loss)
    def wrapper(self, *args, **kwargs):
        with batch_statistics():
            return loss(self, *args, **kwargs)
    return wrapper


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in the input's
    dtype, as Flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does. Inside
    ``ops.quant.int8_predict_scope`` an eligible conv runs the int8 path."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.INTERCEPT is not None:
            out = quant.INTERCEPT(self, x)
            if out is not None:
                return out
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in the input's
    dtype, as Flax's ``nn.Dense(dtype=..., param_dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Scale(nn.Module):
    """Learnable scalar multiplier (per-FPN-level bbox scaling in FCOS)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init_value, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis as the JAX package runs Flax's
    ``nn.LayerNorm(dtype=float32)``: the input taken to float32, eps 1e-6
    (Flax's default; torch's is 1e-5), the output cast back to the input's
    dtype. ``weight`` and ``bias`` are the Flax ``scale`` and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation (torch defaults to erf)."""
    return F.gelu(x, approximate="tanh")


class FrozenBatchNorm(nn.Module):
    """Fixed per-channel affine y = x * scale + bias, computed in x's dtype.

    ``scale`` and ``bias`` are buffers (never trained), as the JAX package
    keeps them in its ``buffers`` collection."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm that reduces in float32 and casts back to the input dtype.

    eps is 1e-6, Flax's ``nn.GroupNorm`` default (torch's is 1e-5)."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__(num_groups, features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """Trainable batch normalisation over dim 1 with running statistics
    (counterpart of the JAX package's ``layers.BatchNorm``, torch
    ``BatchNorm2d`` semantics):

    - inside ``batch_statistics()``: normalise by the biased batch mean and
      variance, computed in float32 in two passes (``mean((x - mean)^2)``,
      never ``E[x^2] - E[x]^2``, which cancels and can go negative), then
      ``running = (1 - momentum) * running + momentum * stat`` with the
      running variance from the unbiased ``n / (n - 1)`` variance, ``n`` the
      count of the (global) batch;
    - outside it: normalise by the running statistics.

    The affine is applied as ``x * inv + (bias - mean * inv)`` with both
    factors cast to x's dtype, the JAX module's order, so bfloat16 rounds
    alike. A module applied several times in one loss (a head shared by the
    pyramid levels) takes each call's own statistics and updates its running
    ones call by call, as Flax does. ``weight``, ``bias``, ``running_mean``
    and ``running_var`` are the Flax ``scale``, ``bias``, ``mean`` and
    ``var``; there is no ``num_batches_tracked``."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _batch_moments(self, x: torch.Tensor, sync: bool):
        xf = x.float()
        dims = [0, *range(2, x.ndim)]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        stats = torch.cat([xf.sum(dims), xf.new_tensor([x.numel() // x.shape[1]])])
        if sync:
            stats = sum_over_processes(stats)
        n = stats[-1]
        mean = stats[:-1] / n
        sq = torch.square(xf - mean.view(shape)).sum(dims)
        var = (sum_over_processes(sq) if sync else sq) / n
        return mean, var, n

    @torch.no_grad()
    def _update_running(self, mean, var, n):
        m = self.momentum
        unbiased = var * (n / torch.clamp(n - 1, min=1))
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sync = getattr(_BATCH_STATS, "mode", None)
        if sync is None:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var, n = self._batch_moments(x, sync)
            if getattr(_BATCH_STATS, "update", True):
                self._update_running(mean, var, n)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = self.weight * torch.rsqrt(var + self.eps)
        return (x * inv.to(x.dtype).view(shape)
                + (self.bias - mean * inv).to(x.dtype).view(shape))


def has_batch_stats(model: nn.Module) -> bool:
    """True iff ``model`` holds a trainable ``BatchNorm`` (the JAX package's
    test for live running statistics in its buffers)."""
    return any(isinstance(m, BatchNorm) for m in model.modules())


@torch.no_grad()
def precise_bn_stats(model: nn.Module, image_batches: Iterable,
                     momentum: float = 0.1) -> bool:
    """Recompute every ``BatchNorm``'s running statistics over
    ``image_batches`` (uint8 (B, H, W, 3) images), in place, by the JAX
    package's mechanism (``layers.precise_bn_stats``): a batch at a time,
    every mean and var is zeroed and ONE forward with batch statistics runs,
    whose update leaves ``momentum * stat`` (for a module applied several
    times in a forward, the momentum-weighted mix of its calls'
    statistics); those are summed in float64 and divided by ``momentum *
    count``. The statistics are the process's own (no reduction over a
    process group): every process recomputes them over the same images.
    Returns False, changing nothing, where the model has no BatchNorm."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if not bns:
        return False
    dev = bns[0].running_mean.device
    total = [[torch.zeros_like(b.running_mean, dtype=torch.float64) for _ in range(2)]
             for b in bns]
    count = 0
    for images in image_batches:
        for b in bns:
            b.running_mean.zero_()
            b.running_var.zero_()
        with batch_statistics(sync=False):
            model(torch.as_tensor(np.asarray(images), device=dev))
        for b, (tm, tv) in zip(bns, total):
            tm += b.running_mean.double()
            tv += b.running_var.double()
        count += 1
    if count == 0:
        raise ValueError("precise_bn_stats needs at least one batch")
    for b, (tm, tv) in zip(bns, total):
        b.running_mean.copy_((tm / (momentum * count)).float())
        b.running_var.copy_((tv / (momentum * count)).float())
    return True


class DeformConvLayer(nn.Module):
    """3x3 deformable conv with the absolute-offset convention of
    ``ops/deform_conv.py`` (counterpart of the JAX package's
    ``meta_arch/reppoints.py:DeformConvLayer``): a float32 (K, Cin, Cout)
    ``weight`` drawn from normal(0, 0.01) and a zero ``bias``.

    Channels last: ``x`` (B, H, W, Cin) with offsets (B, H, W, K, 2), or
    ``samples`` (B, H, W, K, Cin) gathered once for several convs at the same
    offsets; the output (B, H, W, Cout) is in the input's dtype."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(9, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x=None, offsets=None, samples=None, mask=None):
        if samples is not None:
            return deform_apply(samples, self.weight, self.bias)
        return deform_conv2d_batched(x, offsets.float(), self.weight, self.bias, mask)


class DFConv2d(DeformConvLayer):
    """Offset-predicting 3x3 deformable conv, stride 1 (counterpart of the
    JAX package's ``layers.py:DFConv2d``): a zero-initialised 3x3
    ``offset_conv`` predicts 18 offsets (v1) or 27, offsets and a sigmoid
    mask (v2, ``modulated``), in torch DCN's relative (dy, dx) x 9 convention,
    shifted by ``kernel_base_offsets(3)`` to absolute ones. NCHW in and out
    (``channels_last`` memory)."""

    def __init__(self, in_channels: int, features: int, modulated: bool = True):
        super().__init__(in_channels, features)
        self.modulated = modulated
        self.offset_conv = Conv2d(in_channels, 27 if modulated else 18, 3, padding=1)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        pred = self.offset_conv(x).float().permute(0, 2, 3, 1)     # (B, H, W, 27)
        rel = pred[..., :18].reshape(b, h, w, 9, 2)
        mask = torch.sigmoid(pred[..., 18:]) if self.modulated else None
        base = torch.as_tensor(kernel_base_offsets(3), device=x.device)
        out = super().forward(x.permute(0, 2, 3, 1), rel + base, mask=mask)
        return out.permute(0, 3, 1, 2)


def get_norm(norm: str, features: int) -> Optional[nn.Module]:
    """Norm factory: "" (none), "FrozenBN", "GN" and "BN" / "SyncBN", one
    module (``BatchNorm`` reduces over the process group in both)."""
    if norm == "" or norm is None:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(features)
    if norm == "GN":
        return GroupNorm32(features)
    if norm in ("BN", "SyncBN"):
        return BatchNorm(features)
    raise ValueError(f"Unknown norm {norm!r}")


@torch.no_grad()
def init_detector_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of a detector from ``generator`` (a CPU generator)
    as the JAX package initialises them: backbone and FPN convs lecun-normal
    (untruncated here), convs under ``head.`` normal(0, 0.01), conv biases 0,
    norms (BatchNorm's running statistics at mean 0, var 1) and scales at
    identity. Modules are visited in ``named_modules``
    order, which fixes the order of the draws; the caller sets the
    classification bias to its focal prior afterwards. A deformable conv's
    (K, Cin, Cout) weight is drawn from normal(0, 0.01) wherever it sits, and
    a ``DFConv2d``'s ``offset_conv`` starts at zero, so that its samples
    start on the plain conv's grid (a conv of another name or parent is
    drawn like any other). The transformer trunks' linear layers are drawn
    lecun-normal with zero biases (Flax's ``Dense`` and ``DenseGeneral``),
    their LayerNorms at identity and their ``pos_embed{i}`` from normal(0,
    0.02); the R-CNN box head's linear layers (``roi_box.``) are left to
    ``RCNN.init_weights``, which draws them with its own deviations."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    dcn_offsets = {id(m.offset_conv) for m in model.modules() if isinstance(m, DFConv2d)}
    for name, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if pname.startswith("pos_embed"):
                normal(p, 0.02)
        if isinstance(m, nn.Linear) and not name.startswith("roi_box."):
            normal(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, DeformConvLayer):
            normal(m.weight, 0.01)
            m.bias.zero_()
        elif id(m) in dcn_offsets:
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            if name.startswith("head."):
                std = 0.01
            else:
                std = 1.0 / math.sqrt(m.weight[0].numel())
            normal(m.weight, std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)


def prior_bias(prior_prob: float) -> float:
    """The classification bias at which sigmoid gives ``prior_prob``."""
    return -math.log((1 - prior_prob) / prior_prob)
