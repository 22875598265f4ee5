"""One training step (counterpart of
``slenderobjdet_tpu/engine/train_loop.py:make_train_step``): forward and
loss in ``TPU.COMPUTE_DTYPE`` with float32 master parameters (the model's
layers cast each weight to the compute dtype), backward, gradient clipping,
the LR of the step's schedule and the optimizer update.

Running statistics: a trainable ``BatchNorm`` (``models/layers.py``)
updates its running mean and variance in place during the loss's forward,
from the batch statistics of the parameters before the update; the JAX step
writes the same values, returned by the loss apply, into
``TrainState.buffers`` after the update, so the two states agree after each
step. A detector-level running statistic, the RepPoints EMA loss
normaliser, is reported by ``loss`` as ``metrics["loss_normalizer"]`` and
copied into the model's ``loss_normalizer`` buffer after the update, as the
JAX train step writes it into ``TrainState.buffers``.

The update count is state (the JAX package's ``TrainState.step``): a
checkpoint saves it and a resumed run sets it, so the LR schedule goes on
where it stopped.

``step_generator`` is the per-step source of training randomness (the R-CNN
subsampling), the counterpart of ``fold_in(PRNGKey(SEED + 7919), i)``: a
function of the seed, the iteration and the rank only, so that a resumed run
draws what an uninterrupted one draws and no two ranks draw alike.

Data parallelism: in a process group the step runs the loss through
``DistributedDataParallel`` around a module whose ``forward`` is the model's
``loss`` (DDP prepares its gradient reducer in its own ``forward``, so
calling ``model.loss`` past it would skip the average). DDP averages the
gradients bucket by bucket while the backward runs, so ``clip_gradients``
and the update see the global gradient on every rank. The losses divide by
global counts (``parallel.multihost.global_normalizer``), which makes that
average the gradient of the JAX loss on the joined batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..solver.build import clip_gradients, lr_schedule


class _Loss(nn.Module):
    """The module DDP wraps: its ``forward`` is the model's ``loss``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.loss(batch)


def data_parallel_loss(model):
    """``model.loss``, or in a process group, DDP around it. Every trainable
    parameter reaches every family's loss, so no unused-parameter search
    runs; buffers are not broadcast, since those that change are equal on
    every rank already: RepPoints' EMA normaliser is computed from global
    counts, and a BatchNorm's running statistics from the statistics of the
    global batch (its reduction over the process group)."""
    if not dist.is_available() or not dist.is_initialized():
        return model.loss
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(_Loss(model), broadcast_buffers=False)


class TrainStep:
    """``step(batch)`` -> metrics, detached tensors: ``total_loss`` and
    whatever the model's ``loss`` reports (FCOS: ``cls_loss``, ``reg_loss``,
    ``centerness_loss``, ``num_pos``; RetinaNet: ``loss_cls``,
    ``loss_box_reg``, ``num_pos``; R-CNN: ``loss_rpn_cls``, ``loss_rpn_loc``,
    ``loss_cls``, ``loss_box_reg``, ``num_fg``; RepPoints: ``loss_cls``,
    ``loss_localization_init``, ``loss_localization_refine``, ``num_pos``,
    ``loss_normalizer``; the ablation chassis: ``loss_cls``,
    ``loss_loc_init``, ``loss_loc_refine``, ``num_pos`` and, for LRTB,
    ``centerness_loss``; FCOSAnchor: FCOS's and ``shape_loss``; CornerNet:
    ``loss_heat``, ``loss_pull``, ``loss_push``, ``loss_offset``,
    ``num_pos``).
    ``count`` is the number of updates made so far; it starts at 0, so the
    first update uses ``schedule(0)`` as optax does."""

    def __init__(self, model, optimizer: torch.optim.Optimizer, cfg):
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.count = 0
        self.loss = data_parallel_loss(model)

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics = self.loss(batch)
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


def step_generator(seed: int, iteration: int, device, rank: int = 0) -> torch.Generator:
    """The generator of iteration ``iteration`` on ``device``, seeded from
    ``seed + 7919`` and the iteration; a rank other than 0 folds itself in
    (rank 0 draws what a single process draws)."""
    value = ((max(seed, 0) + 7919) << 32) + iteration
    if rank:
        value = int(np.random.SeedSequence([value, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    cfg) -> TrainStep:
    return TrainStep(model, optimizer, cfg)
