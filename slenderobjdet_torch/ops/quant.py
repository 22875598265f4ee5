"""Int8 inference (counterpart of ``slenderobjdet_tpu/ops/quant.py``): route
wide convolutions through an s8 x s8 -> s32 product without touching any
model code. Two modes:

- dynamic (``TPU.INT8_PREDICT`` alone): a per-tensor max-abs activation
  scale computed in the graph; only the wide >= 3x3 convs are taken over
  (``eligible``: taps >= 9, >= 256 input and >= 128 output channels);
- static (with ``TPU.INT8_SCALES``, a JSON of ``{module path: amax}``
  written by ``tools/int8_calibrate.py``): per-conv constant scales, which
  make the quantize pass purely elementwise and extend coverage to every
  conv of >= 128 input and >= 128 output channels, 1x1s included
  (``static_eligible``).

How: ``int8_predict_scope(enabled)`` makes ``layers.Conv2d.forward`` ask
``intercept`` first, which replaces an eligible conv's call with
``int8_conv_call``:

- weights: per-output-channel symmetric int8 (max-abs / 127), computed from
  the fp32 parameters on every call (``quantize_conv_kernel``);
- activations: per-tensor symmetric int8, dynamic (``dynamic_quantize``) or
  from the calibrated amax;
- the product: im2col of the int8 activations and ``torch._int_mm`` (a
  library GEMM, on the CPU and on the card), s32 sums exact, then one
  rescale by (activation scale x the channel's weight scale) plus the fp32
  bias, cast to the input's dtype.

``layers.Conv2d`` is the port's counterpart of Flax's ``nn.Conv``, the only
class the JAX interceptor takes over (``type(mod) is nn.Conv``): deformable
convs, the fused stem and the fused blocks are other code and are never
taken over. Sites are named by their Flax path (``module_path``,
``backbone/bottom_up/res3_0/conv1``), so that a scales file of the JAX
package applies as it is.

The thresholds are the JAX package's, measured there on a TPU; the H100's
own figures are in ``PERF.md``.
"""

from __future__ import annotations

import json
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

MIN_IN_FEATURES = 256
MIN_OUT_FEATURES = 128
MIN_KERNEL_TAPS = 9
# the JAX package's default floor, at which its scales file was calibrated
STATIC_MIN_IN_FEATURES = 128
STATIC_MIN_OUT_FEATURES = 128

# Active static scales: the per-call override of ``static_scales_scope``
# (_UNSET: fall through to the process default of ``set_default_scales``;
# None: static scales off).
_UNSET = object()
_STATIC_SCALES: Any = _UNSET
_DEFAULT_SCALES: Optional[Dict[str, float]] = None

# What ``layers.Conv2d.forward`` asks first: None, or a callable (conv, x)
# returning the conv's output, or None to run the conv as it is.
INTERCEPT: Optional[Callable] = None

_CONV_BN_RELU = "ConvBNRelu"      # its conv is Flax's auto-named Conv_0


def name_sites(root: nn.Module) -> None:
    """Give every ``Conv2d`` under ``root`` its Flax path (``module_path``):
    the module's qualified name joined by "/", a ``ConvBNRelu``'s ``conv``
    named ``Conv_0`` (the inverse of ``checkpoint/bridge.py``'s renaming)."""
    modules = dict(root.named_modules())
    for name, mod in modules.items():
        if isinstance(mod, nn.Conv2d):
            parts = name.split(".")
            parent = modules[".".join(parts[:-1])]
            if parts[-1] == "conv" and type(parent).__name__ == _CONV_BN_RELU:
                parts[-1] = "Conv_0"
            mod.site = "/".join(parts)


def module_path(mod: nn.Module) -> str:
    """The conv's Flax path, as ``name_sites`` set it."""
    site = getattr(mod, "site", None)
    if site is None:
        raise ValueError("int8: a conv without a site name; build the model with "
                         "build_model or call quant.name_sites(model)")
    return site


def quantize_conv_kernel(weight: torch.Tensor):
    """(out, in, kh, kw) float weights -> (int8 weights, (out,) f32 scales)."""
    w32 = weight.float()
    s = w32.abs().amax(dim=(1, 2, 3)) / 127.0
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(w32 / s[:, None, None, None]), -127, 127)
    return q.to(torch.int8), s


def dynamic_quantize(x: torch.Tensor):
    """Per-tensor symmetric int8: (int8 tensor, scalar f32 scale)."""
    x32 = x.float()
    s = x32.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def _is_plain(mod: nn.Conv2d) -> bool:
    """Only convs whose semantics ``int8_conv_call`` replicates exactly."""
    return tuple(mod.dilation) == (1, 1)


def eligible(mod: Any, x: torch.Tensor) -> bool:
    """Dynamic-quantize eligibility: taps >= 9, >= 256 in, >= 128 out."""
    if not isinstance(mod, nn.Conv2d) or x.dim() != 4:
        return False
    kh, kw = mod.kernel_size
    if kh * kw < MIN_KERNEL_TAPS:
        return False
    if x.shape[1] < MIN_IN_FEATURES or mod.out_channels < MIN_OUT_FEATURES:
        return False
    return _is_plain(mod)


def static_eligible(mod: Any, x: torch.Tensor) -> bool:
    """Static-scale eligibility: any plain conv wide enough on both ends."""
    if not isinstance(mod, nn.Conv2d) or x.dim() != 4:
        return False
    if x.shape[1] < STATIC_MIN_IN_FEATURES or mod.out_channels < STATIC_MIN_OUT_FEATURES:
        return False
    return _is_plain(mod)


def im2col(xq: torch.Tensor, kernel_size, stride, padding) -> torch.Tensor:
    """NHWC int8 activations -> (B * Ho * Wo, kh * kw * C) patches, tap-major
    (ky, kx, c), zeros outside the image."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    if ph or pw:
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
    p = xq.unfold(1, kh, sh).unfold(2, kw, sw)          # B, Ho, Wo, C, kh, kw
    b, ho, wo = p.shape[:3]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1), (b, ho, wo)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) int8 -> (M, N) int32 through ``torch._int_mm``, M
    padded above 16 and K and N to multiples of 8 with zeros (the card's
    constraints; the sums are unchanged)."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a, b)[:m, :n]


def int8_sums(mod: nn.Conv2d, xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The conv's s32 sums, NHWC (B, Ho, Wo, out), from int8 NCHW activations
    and int8 (out, in / groups, kh, kw) weights, a GEMM a group."""
    groups = mod.groups
    xh = xq.permute(0, 2, 3, 1)
    cin, cout = xh.shape[3] // groups, wq.shape[0] // groups
    outs = []
    for g in range(groups):
        cols, (b, ho, wo) = im2col(xh[..., g * cin:(g + 1) * cin], mod.kernel_size,
                                   mod.stride, mod.padding)
        wg = wq[g * cout:(g + 1) * cout].permute(0, 2, 3, 1).reshape(cout, -1)
        outs.append(int8_matmul(cols, wg.t().contiguous()))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(b, ho, wo, -1)


def int8_conv_call(mod: nn.Conv2d, x: torch.Tensor,
                   act_scale: Optional[float] = None) -> torch.Tensor:
    """The quantized replacement of an eligible conv's forward (x NCHW).

    ``act_scale`` None: per-tensor dynamic max-abs; set: the calibrated
    amax (elementwise quantize, values clip at the calibrated range)."""
    wq, ws = quantize_conv_kernel(mod.weight)
    if act_scale is None:
        xq, xs = dynamic_quantize(x)
    else:
        xs = x.new_tensor(max(act_scale, 1e-12) / 127.0, dtype=torch.float32)
        xq = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
    acc = int8_sums(mod, xq, wq)
    out = acc.float() * (xs * ws)
    if mod.bias is not None:
        out = out + mod.bias.float()
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _active_scales() -> Optional[Dict[str, float]]:
    return _DEFAULT_SCALES if _STATIC_SCALES is _UNSET else _STATIC_SCALES


def set_default_scales(scales: Optional[Dict[str, float]]) -> None:
    """Process-wide default static scales (``build_model`` sets them from
    ``TPU.INT8_SCALES``); ``static_scales_scope`` overrides them per call."""
    global _DEFAULT_SCALES
    _DEFAULT_SCALES = dict(scales) if scales else None


def load_json_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}


def intercept(mod: nn.Conv2d, x: torch.Tensor) -> Optional[torch.Tensor]:
    """``int8_predict_scope``'s rule: the static path where the conv has a
    calibrated scale, else the dynamic path where it is eligible, else None
    (the conv runs as it is)."""
    scales = _active_scales()
    if scales is not None and static_eligible(mod, x):
        amax = scales.get(module_path(mod))
        if amax is not None:
            return int8_conv_call(mod, x, act_scale=amax)
    if eligible(mod, x):
        return int8_conv_call(mod, x)
    return None


@contextmanager
def _intercepting(fn: Callable):
    global INTERCEPT
    prev = INTERCEPT
    INTERCEPT = fn
    try:
        yield
    finally:
        INTERCEPT = prev


def int8_predict_scope(enabled: bool):
    """``with int8_predict_scope(cfg.TPU.INT8_PREDICT): outputs = model(images)``.

    Dynamic-quantizes the eligible convs; additionally uses static
    calibrated scales for any conv in the active scales (which widens
    eligibility to 1x1s)."""
    if not enabled:
        return nullcontext()
    return _intercepting(intercept)


@contextmanager
def static_scales_scope(scales: Optional[Dict[str, float]]):
    """Calibrated ``{module path: amax}`` for any ``int8_predict_scope``
    opened inside, overriding the process default; None disables static
    scales."""
    global _STATIC_SCALES
    prev = _STATIC_SCALES
    _STATIC_SCALES = dict(scales) if scales else None
    try:
        yield
    finally:
        _STATIC_SCALES = prev


def _recorder(records: Dict[str, Any], to_host: bool):
    def record(mod, x):
        if static_eligible(mod, x):
            key = module_path(mod)
            amax = x.float().abs().amax()
            if to_host:
                amax = float(amax)
            records[key] = (amax if key not in records
                            else (max(records[key], amax) if to_host
                                  else torch.maximum(records[key], amax)))
        return None
    return record


def traced_calibration(fn: Callable) -> Callable:
    """Wrap a predict-like callable so that it also returns ``{path: amax}``
    (0-d tensors, no host sync a conv) for every static-eligible conv, the
    model running in full precision:

        out, amaxes = traced_calibration(model.predict)(batch)
        scales = {k: float(v) for k, v in amaxes.items()}

    Accumulate the ``max`` over batches on the host."""
    def wrapped(*args, **kwargs):
        records: Dict[str, Any] = {}
        with _intercepting(_recorder(records, to_host=False)):
            out = fn(*args, **kwargs)
        return out, records
    return wrapped


@contextmanager
def calibration_scope(sink: Dict[str, float]):
    """Record each static-eligible conv's input max-abs into ``sink`` (host
    floats, the running max across calls) while the model runs in full
    precision."""
    with _intercepting(_recorder(sink, to_host=True)):
        yield
