"""Inference loop with the reference's benchmark protocol
(`slender_det/evaluation/evaluator.py:12-96`): warmup iterations excluded,
pure-compute time measured with forced synchronization: the fetch of the
detections to the host, one ``.cpu()`` a tensor a batch, which waits for the
card. Counterpart of ``slenderobjdet_tpu/evaluation/evaluator.py``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..parallel.multihost import process_index

logger = logging.getLogger(__name__)


def _to_host(v) -> np.ndarray:
    """A detection tensor as a numpy array; bfloat16, which numpy lacks, is
    widened to float32 (exact)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def inference_on_dataset(
    predict_fn: Callable[[Dict], Dict],
    data_loader,
    evaluator,
    warmup: int = 5,
) -> Dict:
    """predict_fn: batch -> detections (tensors on the card). Returns evaluator
    results (rank 0's metrics; other ranks' evaluators return none) and
    this rank's own ``_timing``; logs pure-compute s/img like the
    reference."""
    evaluator.reset()

    total_compute_time = 0.0
    total_images = 0
    idx = -1
    batches = list(data_loader) if hasattr(data_loader, "__next__") else data_loader
    if hasattr(batches, "__len__"):
        # don't let warmup swallow the whole (small) dataset
        warmup = min(warmup, max(len(batches) - 1, 0))
    data_loader = batches
    for idx, batch in enumerate(data_loader):
        t0 = time.perf_counter()
        outputs = predict_fn(batch)
        outputs = {k: _to_host(v) for k, v in outputs.items()}  # sync fetch
        compute_time = time.perf_counter() - t0

        n_valid = sum(batch.get("batch_valid", [True] * len(batch["image_id"])))
        if idx >= warmup:
            total_compute_time += compute_time
            total_images += n_valid

        evaluator.process(batch, outputs)

    if total_images > 0:
        logger.info(
            "Rank %d: total inference pure compute time: %.4fs (%.4f s/img on %d "
            "images)", process_index(),
            total_compute_time,
            total_compute_time / total_images,
            total_images,
        )
    results = evaluator.evaluate()
    results["_timing"] = {
        "pure_compute_s": total_compute_time,
        "images": total_images,
        "s_per_img": total_compute_time / total_images if total_images else 0.0,
    }
    return results
