"""One training step (counterpart of
``slenderobjdet_tpu/engine/train_loop.py:make_train_step``): forward and
loss in ``TPU.COMPUTE_DTYPE`` with float32 master parameters (the model's
layers cast each weight to the compute dtype), backward, gradient clipping,
the LR of the step's schedule and the optimizer update.

FrozenBN only: no BatchNorm statistics are written back, and trainable BN
raises at model build. The trainer, its hooks, checkpoints and DDP are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..solver.build import clip_gradients, lr_schedule


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    cfg) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``step(batch)`` -> metrics (``total_loss``, ``cls_loss``,
    ``reg_loss``, ``centerness_loss``, ``num_pos``), detached tensors. The
    update count starts at 0, so the first update uses ``schedule(0)`` as
    optax does."""
    schedule = lr_schedule(cfg)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    count = 0

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        nonlocal count
        optimizer.zero_grad(set_to_none=True)
        total, metrics = model.loss(batch)
        total.backward()
        clip_gradients(cfg, params)
        lr = schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr * group["lr_factor"]
        optimizer.step()
        count += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["total_loss"] = total.detach()
        return out

    return step
