"""Optimizer and LR schedule (counterpart of
``slenderobjdet_tpu/solver/build.py``, which builds an optax chain).

- ``lr_schedule``: WarmupMultiStepLR, ``BASE_LR * warmup * GAMMA^(#STEPS
  passed)`` with linear or constant warmup, evaluated at the update count
  (0 for the first update, as optax's ``scale_by_learning_rate`` does).
- ``build_optimizer``: ``MODEL.BACKBONE.FREEZE_AT`` as ``requires_grad_(False)``
  (the JAX package zeroes those updates, weight decay included), then
  parameter groups labelled in detectron2's order (any ``bias``, a norm's
  included, is a bias; a GroupNorm, BatchNorm or LayerNorm weight or
  ``Scale.scale``, the Flax ``scale`` leaves, is a norm; the rest is regular) with ``WEIGHT_DECAY{,_NORM,_BIAS}`` and
  ``BIAS_LR_FACTOR`` as each group's ``lr_factor``.
- ``clip_gradients``: ``SOLVER.CLIP_GRADIENTS`` as optax's ``clip`` (by
  value) or ``clip_by_global_norm``.

SGD folds the weight decay into the gradient before the momentum, as the
optax chain does, and so does torch's ``SGD(weight_decay=...)``; ADAM and
ADAMW are torch's ``Adam`` and ``AdamW``, the same updates as optax's chains
up to float rounding. ADAGRAD is ``Adagrad`` below, optax's chain written
out, since torch's ``Adagrad`` starts its accumulator at 0 and divides by
``sqrt(sum) + eps`` where optax's ``scale_by_rss`` starts at 0.1 and takes
``rsqrt(sum + 1e-7)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from ..models.layers import BatchNorm, LayerNorm, Scale


class Adagrad(torch.optim.Optimizer):
    """optax's ``add_decayed_weights`` -> ``scale_by_rss(0.1, 1e-7)`` ->
    ``scale_by_learning_rate``: the group's weight decay is added to the
    gradient, the sum of squares starts at ``initial_accumulator_value``, and
    the update is ``-lr * g * rsqrt(sum + eps)`` (0 where the sum is 0). The
    caller sets each group's ``lr`` before a step, as for every optimizer
    here; the state, one ``sum`` a parameter, goes through ``state_dict``."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, eps=eps,
            initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"].addcmul_(g, g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_(g * scale, alpha=-group["lr"])
        return loss


def lr_schedule(cfg) -> Callable[[int], float]:
    s = cfg.SOLVER
    base_lr, steps, gamma = s.BASE_LR, tuple(s.STEPS), s.GAMMA
    warmup_iters, warmup_factor = s.WARMUP_ITERS, s.WARMUP_FACTOR
    method = s.WARMUP_METHOD

    def schedule(step: int) -> float:
        wf = 1.0
        if method == "linear" and step < warmup_iters:
            alpha = step / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha
        elif method == "constant" and step < warmup_iters:
            wf = warmup_factor
        decay = 1.0
        for m in steps:
            if step >= m:
                decay *= gamma
        return base_lr * wf * decay

    return schedule


def frozen(cfg, name: str) -> bool:
    """Whether FREEZE_AT freezes the parameter ``name`` (matched on the
    path as the JAX package's ``_freeze_mask`` does)."""
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_AT
    # the stem's norm is ``bottom_up/<Norm>_0`` in the Flax tree, a path
    # without "stem": a trainable stem norm trains, as in the JAX package
    if freeze_at >= 1 and "stem" in name.replace(".stem_norm.", "."):
        return True
    return any(freeze_at >= stage and f"res{stage}_" in name
               for stage in range(2, 6))


def param_labels(model: nn.Module) -> Dict[str, str]:
    """name -> "bias", "norm" or "regular" for every parameter."""
    labels = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            if pname == "bias":
                label = "bias"
            elif isinstance(module, (nn.GroupNorm, BatchNorm, LayerNorm, Scale)):
                label = "norm"
            else:
                label = "regular"
            labels[f"{mname}.{pname}" if mname else pname] = label
    return labels


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    s = cfg.SOLVER
    optim = s.OPTIM.upper()
    wd = {"regular": s.WEIGHT_DECAY, "norm": s.WEIGHT_DECAY_NORM,
          "bias": s.WEIGHT_DECAY_BIAS}
    lr_factor = {"regular": 1.0, "norm": 1.0,
                 "bias": float(getattr(s, "BIAS_LR_FACTOR", 1.0))}
    labels = param_labels(model)
    members: Dict[str, List[nn.Parameter]] = {g: [] for g in wd}
    for name, p in model.named_parameters():
        if frozen(cfg, name):
            p.requires_grad_(False)
        else:
            members[labels[name]].append(p)
    groups = [{"params": ps, "weight_decay": wd[g], "lr_factor": lr_factor[g],
               "lr": s.BASE_LR * lr_factor[g], "label": g}
              for g, ps in members.items() if ps]
    if optim == "SGD":
        return torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM,
                               nesterov=s.NESTEROV)
    if optim == "ADAM":
        return torch.optim.Adam(groups, lr=s.BASE_LR)
    if optim == "ADAMW":
        return torch.optim.AdamW(groups, lr=s.BASE_LR)
    if optim == "ADAGRAD":
        return Adagrad(groups, lr=s.BASE_LR)
    raise ValueError(f"Unknown SOLVER.OPTIM {s.OPTIM!r}")


def clip_gradients(cfg, params) -> None:
    """Clip the gradients of ``params`` in place per SOLVER.CLIP_GRADIENTS:
    elementwise to +-CLIP_VALUE, or scaled so that their global L2 norm is
    at most CLIP_VALUE (optax's clip_by_global_norm: no epsilon)."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if c.CLIP_TYPE == "value":
        for g in grads:
            g.clamp_(-c.CLIP_VALUE, c.CLIP_VALUE)
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < c.CLIP_VALUE, 1.0, c.CLIP_VALUE / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
