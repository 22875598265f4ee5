"""One training step (counterpart of
``slenderobjdet_tpu/engine/train_loop.py:make_train_step``): forward and
loss in ``TPU.COMPUTE_DTYPE`` with float32 master parameters (the model's
layers cast each weight to the compute dtype), backward, gradient clipping,
the LR of the step's schedule and the optimizer update.

FrozenBN only: no BatchNorm statistics are written back, and trainable BN
raises at model build. The update count is state (the JAX package's
``TrainState.step``): a checkpoint saves it and a resumed run sets it, so
the LR schedule goes on where it stopped.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..solver.build import clip_gradients, lr_schedule


class TrainStep:
    """``step(batch)`` -> metrics (``total_loss``, ``cls_loss``,
    ``reg_loss``, ``centerness_loss``, ``num_pos``), detached tensors.
    ``count`` is the number of updates made so far; it starts at 0, so the
    first update uses ``schedule(0)`` as optax does."""

    def __init__(self, model, optimizer: torch.optim.Optimizer, cfg):
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.count = 0

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics = self.model.loss(batch)
        total.backward()
        clip_gradients(self.cfg, self.params)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_factor"]
        self.optimizer.step()
        self.count += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["total_loss"] = total.detach()
        return out


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    cfg) -> TrainStep:
    return TrainStep(model, optimizer, cfg)
