"""Serving export (counterpart of ``slenderobjdet_tpu/serving.py``): freeze a
detector's ``predict`` into a ``torch.export`` program plus its weights, so
that a serving process can load and run it without the model-building code
(no config, no model module: only torch and the port's registered kernel
operators, ``slenderobjdet::nms``, ``::fused_stem``, ``::fused_bottleneck``,
``::rotated_iou``, ``::rotated_nms`` and ``::corner_pool``).

The program takes the weights as an input, the JAX package's
``predict(variables, batch)``: they travel beside it rather than as
constants baked into it, so that a checkpoint can be swapped without a new
export. The program is saved as ``torch.export`` traced it, without
decompositions, so that a reload calls the very operators the live model
calls: the hand-written kernels on the card, the plain versions on the CPU.

Artifact layout (a directory):
  model.pt2     ``torch.export.save`` of predict(weights, image, scale,
                orig_size) at a fixed batch and bucket
  weights.pt    the weights (parameters and buffers) by name, ``torch.save``
  meta.json     batch and image shape, device, quantisation, inputs, outputs

``quantize=True`` stores every conv and linear weight as per-output-channel
int8 (``quantize_variables``) and the program dequantizes them in the graph
before use: compute precision is unchanged, the stored weights shrink ~4x.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

# importing these registers the operators an exported program calls
from .ops import corner_pool, fused_bottleneck, fused_stem, nms, rotated  # noqa: F401

ARTIFACT_FILES = ("model.pt2", "weights.pt", "meta.json")
INPUTS = ["image(uint8 BHWC)", "scale(f32 B)", "orig_size(f32 Bx2)"]


# ------------------------------------------------- weight-only quantization
def kernel_names(model: nn.Module) -> set:
    """The weights of the model's convs and linear layers: the Flax tree's
    ``kernel`` leaves (``checkpoint/bridge.py``)."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))}


def quantize_variables(variables: Mapping[str, torch.Tensor],
                       kernels: Iterable[str]) -> Dict[str, Any]:
    """Per-output-channel symmetric int8 of every weight named in
    ``kernels`` (the scale over all axes but the output's, dim 0):
    ``s = max(max |w|, 1e-12) / 127``, ``q = clip(round(w / s), -127, 127)``,
    round half to even, as ``{"q": int8, "s": float32 (out,)}``. Every other
    tensor (biases, norms, buffers) stays as it is."""
    kernels = set(kernels)
    out: Dict[str, Any] = {}
    for name, v in variables.items():
        if name in kernels and v.dim() >= 2:
            w = v.detach().float()
            s = torch.clamp(w.abs().amax(dim=tuple(range(1, w.dim()))), min=1e-12) / 127.0
            q = torch.clamp(torch.round(w / _per_channel(s, w.dim())), -127, 127)
            out[name] = {"q": q.to(torch.int8), "s": s}
        else:
            out[name] = v
    return out


def _per_channel(s: torch.Tensor, dim: int) -> torch.Tensor:
    return s.reshape(-1, *([1] * (dim - 1)))


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def dequantize_variables(qvars: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The float32 weights ``q * s`` of ``quantize_variables``' output."""
    return {k: v["q"].float() * _per_channel(v["s"], v["q"].dim()) if _is_qleaf(v) else v
            for k, v in qvars.items()}


def model_variables(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the model by name, detached."""
    return {k: v.detach() for k, v in
            [*model.named_parameters(), *model.named_buffers()]}


class _Predict(nn.Module):
    """``predict`` as a function of the weights: the model is reached only
    through the weights it is given, so that none is captured as state."""

    def __init__(self, model: nn.Module, quantized: bool):
        super().__init__()
        self.__dict__["model"] = model       # not a submodule: no state
        self.quantized = quantized

    def forward(self, weights, image, scale, orig_size):
        if self.quantized:
            weights = dequantize_variables(weights)
        with torch.nn.utils.stateless._reparametrize_module(self.model, weights):
            return dict(self.model.predict(
                {"image": image, "scale": scale, "orig_size": orig_size}))


def _batch_spec(batch_size: int, h: int, w: int, device) -> Dict[str, torch.Tensor]:
    """Example inputs of the exported program (JAX ``_batch_spec``)."""
    return {"image": torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=device),
            "scale": torch.ones((batch_size,), dtype=torch.float32, device=device),
            "orig_size": torch.full((batch_size, 2), float(max(h, w)), device=device)}


def export_detector(model: nn.Module, path: str, batch_size: int = 1,
                    image_hw=None, quantize: bool = False) -> str:
    """Write ``model.predict`` at a fixed batch and bucket (``image_hw``; the
    model's ``cfg.TPU.TEST_PAD_SHAPE`` where it keeps one) and its weights
    under ``path``. With ``quantize`` the conv and linear weights are stored
    as per-channel int8 and dequantized in the program."""
    if image_hw is None:
        image_hw = model.cfg.TPU.TEST_PAD_SHAPE
    h, w = (int(v) for v in image_hw)
    device = next(model.parameters()).device
    variables = model_variables(model)
    if quantize:
        variables = quantize_variables(variables, kernel_names(model))
    spec = _batch_spec(batch_size, h, w, device)
    with torch.no_grad():
        program = torch.export.export(
            _Predict(model, quantize),
            (variables, spec["image"], spec["scale"], spec["orig_size"]), strict=False)
    program.example_inputs = None            # else the weights go in twice
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, "model.pt2"))
    torch.save(variables, os.path.join(path, "weights.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "batch_size": batch_size,
            "image_hw": [h, w],
            "device": device.type,
            "quantize": "int8-weight-only" if quantize else "none",
            "inputs": INPUTS,
            "outputs": list(program.call_spec.out_spec.context),   # predict's keys
        }, f, indent=2)
    return path


def load_detector(path: str, device: Optional[str] = None) -> Callable[
        [Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Load a serving artifact; returns ``predict_fn(batch) -> detections``
    on ``device`` (the export's device type when None). Needs only torch and
    the port's operators: no model code and no config."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    device = torch.device(device or meta["device"])
    if device.type != meta["device"]:
        raise ValueError(f"load_detector: the program was exported on "
                         f"{meta['device']!r}; it runs there only, not on {device.type!r}")
    program = torch.export.load(os.path.join(path, "model.pt2")).module()
    weights = torch.load(os.path.join(path, "weights.pt"), map_location=device,
                         weights_only=True)
    # the program's own check of every input (the weights included) a call
    # is replaced by the batch's shape check below: the weights are the
    # exported ones
    program.validate_inputs = False
    image_shape = (meta["batch_size"], *meta["image_hw"], 3)

    def predict_fn(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        image, scale, orig_size = (torch.as_tensor(batch[k], device=device)
                                   for k in ("image", "scale", "orig_size"))
        if tuple(image.shape) != image_shape or image.dtype != torch.uint8:
            raise ValueError(f"load_detector: the program takes uint8 images of "
                             f"{image_shape}, got {image.dtype} {tuple(image.shape)}")
        with torch.inference_mode():
            return program(weights, image, scale.float(), orig_size.float())

    return predict_fn
