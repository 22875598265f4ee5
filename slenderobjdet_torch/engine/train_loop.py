"""One training step (counterpart of
``slenderobjdet_tpu/engine/train_loop.py:make_train_step``): forward and
loss in ``TPU.COMPUTE_DTYPE`` with float32 master parameters (the model's
layers cast each weight to the compute dtype), backward, gradient clipping,
the LR of the step's schedule and the optimizer update.

FrozenBN only: no BatchNorm statistics are written back, and trainable BN
raises at model build. A detector-level running statistic is: the RepPoints
EMA loss normaliser, which ``loss`` reports as ``metrics["loss_normalizer"]``
and the step copies into the model's ``loss_normalizer`` buffer after the
update, as the JAX train step writes it into ``TrainState.buffers``.

The update count is state (the JAX package's ``TrainState.step``): a
checkpoint saves it and a resumed run sets it, so the LR schedule goes on
where it stopped.

``step_generator`` is the per-step source of training randomness (the R-CNN
subsampling), the counterpart of ``fold_in(PRNGKey(SEED + 7919), i)``: a
function of the seed and the iteration only, so that a resumed run draws
what an uninterrupted one draws.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..solver.build import clip_gradients, lr_schedule


class TrainStep:
    """``step(batch)`` -> metrics, detached tensors: ``total_loss`` and
    whatever the model's ``loss`` reports (FCOS: ``cls_loss``, ``reg_loss``,
    ``centerness_loss``, ``num_pos``; RetinaNet: ``loss_cls``,
    ``loss_box_reg``, ``num_pos``; R-CNN: ``loss_rpn_cls``, ``loss_rpn_loc``,
    ``loss_cls``, ``loss_box_reg``, ``num_fg``; RepPoints: ``loss_cls``,
    ``loss_localization_init``, ``loss_localization_refine``, ``num_pos``,
    ``loss_normalizer``; the ablation chassis: ``loss_cls``,
    ``loss_loc_init``, ``loss_loc_refine``, ``num_pos`` and, for LRTB,
    ``centerness_loss``; FCOSAnchor: FCOS's and ``shape_loss``).
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
        normalizer = getattr(self.model, "loss_normalizer", None)
        if normalizer is not None and "loss_normalizer" in metrics:
            with torch.no_grad():
                normalizer.copy_(metrics["loss_normalizer"])
        self.count += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["total_loss"] = total.detach()
        return out


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of iteration ``iteration`` on ``device``, seeded from
    ``seed + 7919`` and the iteration."""
    return torch.Generator(device=device).manual_seed(
        ((max(seed, 0) + 7919) << 32) + iteration)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    cfg) -> TrainStep:
    return TrainStep(model, optimizer, cfg)
