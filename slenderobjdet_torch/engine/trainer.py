"""Config-driven trainer (counterpart of
``slenderobjdet_tpu/engine/trainer.py`` and of the reference `BaseTrainer`,
`slender_det/engine/defaults.py:74-178` over d2 DefaultTrainer/SimpleTrainer).

One object wires together: model build, optimizer, data loaders, the train
step, periodic logging (period 20, like the reference's PeriodicWriter),
periodic checkpointing, and eval. The hot loop keeps the card's work
asynchronous: metrics are fetched only on logging iterations, so steps are
enqueued behind the host data loader without a wait in between.

One process and one device: the JAX package's mesh has no counterpart here
(data-parallel training is not ported yet). Not ported either, each raising
NotImplementedError where it is asked for: test-time augmentation
(``TEST.AUG.ENABLED``), the rotated-box evaluator, and ``TEST.PRECISE_BN``
on a model with trainable BatchNorm.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..checkpoint.checkpointer import DetectionCheckpointer
from ..data import build_detection_test_loader, build_detection_train_loader
from ..data.catalog import MetadataCatalog
from ..evaluation import COCOEvaluator, inference_on_dataset
from ..models import build_model
from ..solver import build_optimizer
from .events import CommonMetricPrinter, EventStorage, JSONWriter
from .train_loop import make_train_step

logger = logging.getLogger(__name__)


def default_setup(cfg, args=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    logger.info("torch %s, %d CUDA device(s)", torch.__version__,
                torch.cuda.device_count())
    if cfg.SEED >= 0:
        np.random.seed(cfg.SEED)


class BaseTrainer:
    def __init__(self, cfg, device=None):
        """``device`` None means the card, and a RuntimeError where there is
        none (``build_model``); the CPU is taken only when asked for."""
        self.cfg = cfg
        seed = cfg.SEED if cfg.SEED >= 0 else 0
        self.model = build_model(
            cfg, device=device, generator=torch.Generator().manual_seed(seed))
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.start_iter = 0

        self.optimizer = build_optimizer(cfg, self.model)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)

        self.checkpointer = DetectionCheckpointer(cfg.OUTPUT_DIR)
        self.storage = EventStorage()
        self.writers = [
            CommonMetricPrinter(self.max_iter),
            JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json")),
        ]

    def state(self) -> Dict:
        """What a checkpoint holds: model, optimizer and the update count."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "iteration": self.train_step.count,
        }

    def resume_or_load(self, resume: bool = False):
        self.start_iter = self.checkpointer.resume_or_load(
            self.cfg.MODEL.WEIGHTS, self.model, self.optimizer, resume
        )
        self.train_step.count = self.start_iter

    def train(self):
        cfg = self.cfg
        loader = build_detection_train_loader(cfg, seed=max(cfg.SEED, 0))
        it = iter(loader)
        self.storage.iter = self.start_iter
        data_t0 = time.perf_counter()

        profile_start = cfg.TPU.PROFILE_START_ITER
        profile_stop = profile_start + cfg.TPU.PROFILE_NUM_ITERS
        profiler = None
        for i in range(self.start_iter, self.max_iter):
            if i == profile_start:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if torch.cuda.is_available() else [])])
                profiler.start()
                logger.info("torch.profiler trace started (iters %d..%d)",
                            profile_start, profile_stop - 1)
            host_batch = next(it)
            batch = {
                k: v for k, v in host_batch.items()
                if k not in ("image_id", "batch_valid")
            }
            data_time = time.perf_counter() - data_t0

            metrics = self.train_step(batch)

            if profiler is not None and i + 1 == profile_stop:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                profiler.stop()
                trace_dir = os.path.join(cfg.OUTPUT_DIR, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(trace_dir, "trace.json"))
                profiler = None
                logger.info("torch.profiler trace written to %s", trace_dir)

            if (i + 1) % 20 == 0 or i == self.start_iter:
                fetched = {k: float(v) for k, v in metrics.items()}
                self.storage.put_scalars(data_time=data_time, **fetched)
                for w in self.writers:
                    w.write(self.storage)
            self.storage.step()

            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or (i + 1) == self.max_iter:
                # non-blocking: the host fetch + write run in a thread
                # (which still stalls this loop at the saving iteration,
                # see DetectionCheckpointer.save); has_checkpoint/load join
                # the in-flight save
                self.checkpointer.save(f"model_{i + 1:07d}", self.state(),
                                       blocking=(i + 1) == self.max_iter)
            if cfg.TEST.EVAL_PERIOD > 0 and (i + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self.test()
            data_t0 = time.perf_counter()

        return self.state()

    # ------------------------------------------------------------------ eval
    def test(self) -> Dict:
        cfg = self.cfg
        if cfg.TEST.PRECISE_BN.ENABLED and any(
                isinstance(m, nn.modules.batchnorm._BatchNorm)
                for m in self.model.modules()):
            raise NotImplementedError(
                "TEST.PRECISE_BN with trainable BatchNorm is not ported: it "
                "comes with trainable BN (RepPoints and the ablation chassis)")
        if cfg.TEST.AUG.ENABLED:
            raise NotImplementedError(
                "TEST.AUG.ENABLED (test-time augmentation, engine/tta.py) is "
                "not ported: it comes with serving, int8 and multi-node")

        def predict_fn(batch):
            return self.model.predict({
                "image": batch["image"],
                "scale": batch["scale"],
                "orig_size": batch["orig_size"],
            })

        all_results = {}
        for dataset_name in cfg.DATASETS.TEST:
            evaluator_type = MetadataCatalog.get(dataset_name).get(
                "evaluator_type", "coco"
            )
            if evaluator_type == "rcoco":
                raise NotImplementedError(
                    "the rotated-box evaluator (evaluator_type 'rcoco') is "
                    "not ported: it comes with the rotated detectors")
            evaluator = COCOEvaluator(
                dataset_name, cfg, output_dir=cfg.OUTPUT_DIR
            )
            loader = build_detection_test_loader(cfg, dataset_name,
                                                 batch_size=8)
            results = inference_on_dataset(predict_fn, loader, evaluator)
            logger.info("eval %s: %s", dataset_name, results.get("bbox"))
            all_results[dataset_name] = results
        return all_results
