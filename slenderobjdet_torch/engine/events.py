"""Metric event storage + writers (counterpart of detectron2 EventStorage /
CommonMetricPrinter / JSONWriter used by the reference's BaseTrainer,
`slender_det/engine/defaults.py:89-134`). A copy of
``slenderobjdet_tpu/engine/events.py``."""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class EventStorage:
    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=20))
        self._latest: Dict[str, float] = {}

    def put_scalar(self, name: str, value):
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = value

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else 0.0

    def step(self):
        self.iter += 1


class CommonMetricPrinter:
    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None

    def write(self, storage: EventStorage):
        now = time.perf_counter()
        it_s = ""
        if self._last_time is not None and storage.iter > self._last_iter:
            dt = (now - self._last_time) / (storage.iter - self._last_iter)
            eta = dt * (self.max_iter - storage.iter)
            it_s = f" iter_time: {dt:.4f}s eta: {eta / 60:.1f}min "
        self._last_time, self._last_iter = now, storage.iter
        metrics = "  ".join(
            f"{k}: {v:.4g}" for k, v in sorted(storage.latest().items())
        )
        logger.info("iter %d/%d %s %s", storage.iter, self.max_iter, it_s, metrics)


class JSONWriter:
    def __init__(self, json_file: str):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        record = {"iteration": storage.iter, **storage.latest()}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
