"""Config-driven trainer (counterpart of
``slenderobjdet_tpu/engine/trainer.py`` and of the reference `BaseTrainer`,
`slender_det/engine/defaults.py:74-178` over d2 DefaultTrainer/SimpleTrainer).

One object wires together: model build, optimizer, data loaders, the train
step, periodic logging (period 20, like the reference's PeriodicWriter),
periodic checkpointing, and eval. The hot loop keeps the card's work
asynchronous: metrics are fetched only on logging iterations, so steps are
enqueued behind the host data loader without a wait in between.

One process a device. Under a process group (``parallel/launch.py``) every
rank builds the model on its current device, loads its rows of each global
batch and steps through DDP (``engine/train_loop.py``); rank 0 alone writes
``config.yaml``, ``metrics.json`` and the checkpoints, every rank resumes
from the same file, and ``test`` evaluates each rank's strided share of the
test set and returns the results on rank 0 (``{}`` elsewhere), as the JAX
trainer does across processes. ``TEST.PRECISE_BN`` recomputes a trainable
BatchNorm's running statistics before the evaluation, as the JAX trainer
does (``models/layers.py:precise_bn_stats``). A dataset of evaluator_type
"rcoco" is evaluated by ``RotatedCOCOEvaluator``, any other by
``COCOEvaluator``. ``TEST.AUG.ENABLED`` evaluates each image through
``engine/tta.py:tta_predict`` (multi-scale and flip views merged by a host
NMS), except on an "rcoco" dataset, as the JAX trainer does.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from ..checkpoint.checkpointer import DetectionCheckpointer
from ..data import (build_detection_test_loader, build_detection_train_loader,
                    get_detection_dataset_dicts)
from ..data.catalog import MetadataCatalog
from ..evaluation import COCOEvaluator, inference_on_dataset
from ..evaluation.rotated_evaluation import RotatedCOCOEvaluator
from ..models import build_model
from ..models.layers import has_batch_stats, precise_bn_stats
from ..parallel.multihost import (is_main_process, mean_over_processes, process_count,
                                  process_index, sync_processes)
from ..solver import build_optimizer
from .events import CommonMetricPrinter, EventStorage, JSONWriter
from .train_loop import make_train_step, step_generator
from .tta import tta_predict

logger = logging.getLogger(__name__)


def default_setup(cfg, args=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if is_main_process():   # rank 0's config dump (reference defaults.py)
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    logger.info("torch %s, process %d/%d, %d CUDA device(s)", torch.__version__,
                process_index(), process_count(), torch.cuda.device_count())
    if cfg.SEED >= 0:
        np.random.seed(cfg.SEED)


class BaseTrainer:
    def __init__(self, cfg, device=None):
        """``device`` None means the card (the current device, which
        ``launch`` sets a rank), and a RuntimeError where there is none
        (``build_model``); the CPU is taken only when asked for."""
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
        ] if is_main_process() else []

    def state(self) -> Dict:
        """What a checkpoint holds: model, optimizer and the update count."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "iteration": self.train_step.count,
        }

    def resume_or_load(self, resume: bool = False):
        sync_processes()    # no rank reads last_checkpoint before rank 0 wrote it
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

        device = next(self.model.parameters()).device
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
            # the step's draws (R-CNN subsampling)
            batch["generator"] = step_generator(cfg.SEED, i, device, process_index())
            data_time = time.perf_counter() - data_t0

            metrics = self.train_step(batch)

            if profiler is not None and i + 1 == profile_stop:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                profiler.stop()
                trace_dir = os.path.join(cfg.OUTPUT_DIR, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                rank = process_index()      # one trace a rank
                profiler.export_chrome_trace(os.path.join(
                    trace_dir, f"trace_rank{rank}.json" if rank else "trace.json"))
                profiler = None
                logger.info("torch.profiler trace written to %s", trace_dir)

            if (i + 1) % 20 == 0 or i == self.start_iter:
                # one all-reduce on logging iterations only: the global
                # batch's losses (each rank's loss is its share of them)
                fetched = mean_over_processes(metrics)
                self.storage.put_scalars(data_time=data_time, **fetched)
                for w in self.writers:
                    w.write(self.storage)
            self.storage.step()

            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or (i + 1) == self.max_iter:
                # non-blocking: the host fetch + write run in a thread
                # (which still stalls this loop at the saving iteration,
                # see DetectionCheckpointer.save); has_checkpoint/load join
                # the in-flight save. Rank 0 only (JAX trainer.py:165-173);
                # the others wait for the last, blocking one
                if is_main_process():
                    self.checkpointer.save(f"model_{i + 1:07d}", self.state(),
                                           blocking=(i + 1) == self.max_iter)
                if (i + 1) == self.max_iter:
                    sync_processes()
            if cfg.TEST.EVAL_PERIOD > 0 and (i + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self.test()
            data_t0 = time.perf_counter()

        return self.state()

    # ------------------------------------------------------------------ eval
    def test(self) -> Dict:
        cfg = self.cfg
        if cfg.TEST.PRECISE_BN.ENABLED and has_batch_stats(self.model):
            # the running statistics recomputed over NUM_ITER train batches
            # of the unsharded loader, the same images on every process, and
            # kept in the model, so that the next checkpoint carries them
            loader = iter(build_detection_train_loader(cfg, seed=1, shard_id=0,
                                                       num_shards=1))
            n = max(1, cfg.TEST.PRECISE_BN.NUM_ITER)
            precise_bn_stats(self.model, (next(loader)["image"] for _ in range(n)))
        def predict_fn(batch):
            # image_size: R-CNN clips proposals to the unpadded image
            return self.model.predict({
                k: batch[k] for k in ("image", "scale", "orig_size", "image_size")
                if k in batch})

        all_results = {}
        for dataset_name in cfg.DATASETS.TEST:
            evaluator_type = MetadataCatalog.get(dataset_name).get(
                "evaluator_type", "coco"
            )
            evaluator = (RotatedCOCOEvaluator if evaluator_type == "rcoco"
                         else COCOEvaluator)(dataset_name, cfg, output_dir=cfg.OUTPUT_DIR)
            if cfg.TEST.AUG.ENABLED and evaluator_type != "rcoco":
                # multi-scale + flip TTA (reference train_net.py:128-142
                # wraps the model in GeneralizedRCNNWithTTA for --eval-only)
                results = self._test_with_tta(dataset_name, evaluator)
            else:
                loader = build_detection_test_loader(cfg, dataset_name,
                                                     batch_size=8)
                results = inference_on_dataset(predict_fn, loader, evaluator)
            logger.info("eval %s: %s", dataset_name, results.get("bbox"))
            all_results[dataset_name] = results
        return all_results if is_main_process() else {}

    def _test_with_tta(self, dataset_name, evaluator) -> Dict:
        """``tta_predict`` on every image of this process's strided share of
        the dataset, one image a call; the evaluator gathers the shares."""
        evaluator.reset()
        predict_fns: Dict = {}
        dicts = get_detection_dataset_dicts(dataset_name)
        for d in dicts[process_index()::process_count()]:
            merged = tta_predict(self.model, d, self.cfg, predict_fns=predict_fns)
            n = len(merged["boxes"])
            evaluator.process(
                {"image_id": [d["image_id"]]},
                {
                    "boxes": merged["boxes"][None],
                    "scores": merged["scores"][None],
                    "classes": merged["classes"][None],
                    "valid": np.ones((1, n), bool),
                },
            )
        return evaluator.evaluate()
