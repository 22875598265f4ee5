"""Train and test loaders and their samplers.

Counterpart of `slender_det/data/build.py:40-88`:
- TrainingSampler: infinite shuffled index stream (seeded)
- RepeatFactorTrainingSampler: category-frequency oversampling
- RatioFactorTrainingSampler: slender-object oversampling with the
  reference's exact repeat factors (build.py:16-28: 1.0 if ratio<1/5,
  0.5 if <1/3, else 0.1 — implemented as repeat factor 1+f)
- aspect-ratio (orientation) bucketing: batches are emitted per bucket so
  each maps to one of two compiled shapes (landscape/portrait)
- DATALOADER.NUM_WORKERS > 1 fans the mapper out over a worker THREAD pool
  (the counterpart of torch DataLoader workers the reference relies on,
  SURVEY §2.8) with order-preserving results; cv2/numpy release the GIL for
  the expensive decode/resize work. <= 1 keeps the single-thread prefetcher

Batches are dicts of stacked numpy arrays + host-side lists (image ids).

A copy of ``slenderobjdet_tpu/data/build.py`` that yields the same batches
for the same config, dataset and seed (``tests/test_torch_data.py``). One
difference: the shard layout is never read from a process topology. A
loader is one shard of one; ``num_shards`` > 1 raises until data-parallel
training is ported, and the sharded generators come with it.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from .catalog import DatasetCatalog
from .mapper import DatasetMapper


# --------------------------------------------------------- worker-pool mapper
def mp_map_stream(dataset_dicts, mapper, idx_iter, num_workers: int,
                  seed: int = 0, depth: int = 4):
    """Yields mapper(dataset_dicts[idx]) for idx in idx_iter, mapped by a
    pool of `num_workers` THREADS, in the SAME order as idx_iter.

    Threads, not forked processes: the mapper's expensive work — cv2 decode,
    resize, numpy map rendering — runs in C with the GIL released, so a
    thread pool parallelizes it on a multi-core host, while fork() from a
    multi-threaded process can deadlock children on inherited locks. Each example
    gets an rng keyed by its global sequence number, so results are
    independent of which worker maps it."""
    from concurrent.futures import ThreadPoolExecutor

    def run_one(seq_idx):
        seq, idx = seq_idx
        rng = np.random.default_rng((seed, seq))
        return mapper(dataset_dicts[idx], rng=rng)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: "queue.Queue" = queue.Queue()
        it = enumerate(idx_iter)
        # keep num_workers * depth examples in flight
        for item in itertools.islice(it, num_workers * depth):
            pending.put(pool.submit(run_one, item))
        while not pending.empty():
            fut = pending.get()
            for item in itertools.islice(it, 1):
                pending.put(pool.submit(run_one, item))
            yield fut.result()


# ------------------------------------------------------------------ samplers
def training_sampler(n: int, seed: int = 0, shuffle: bool = True) -> Iterator[int]:
    g = np.random.default_rng(seed)
    while True:
        order = g.permutation(n) if shuffle else np.arange(n)
        yield from order.tolist()


def repeat_factors_from_ratios(dataset_dicts: List[dict]) -> np.ndarray:
    """Reference RatioFactorTrainingSampler factors (data/build.py:16-28)."""
    factors = []
    for d in dataset_dicts:
        f = 0.0
        for anno in d.get("annotations", []):
            r = anno.get("ratio", 1.0)
            if r < 1 / 5:
                f = max(f, 1.0)
            elif r < 1 / 3:
                f = max(f, 0.5)
            else:
                f = max(f, 0.1)
        factors.append(1.0 + f)
    return np.array(factors, np.float64)


def repeat_factor_sampler(
    repeat_factors: np.ndarray, seed: int = 0
) -> Iterator[int]:
    """Stochastic-rounding repeat-factor sampling (d2 semantics)."""
    g = np.random.default_rng(seed)
    n = len(repeat_factors)
    int_part = np.floor(repeat_factors).astype(np.int64)
    frac_part = repeat_factors - int_part
    while True:
        rands = g.random(n)
        reps = int_part + (rands < frac_part).astype(np.int64)
        indices = np.repeat(np.arange(n), reps)
        g.shuffle(indices)
        yield from indices.tolist()


# ------------------------------------------------------------------- batching
def _stack_batch(examples: List[Dict]) -> Dict:
    out = {}
    for key in examples[0]:
        if key == "image_id":
            continue
        out[key] = np.stack([e[key] for e in examples])
    out["image_id"] = [e["image_id"] for e in examples]
    return out


class _Prefetcher:
    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._gen = gen
        self._done = object()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._gen:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


# -------------------------------------------------------------------- loaders
def get_detection_dataset_dicts(names) -> List[dict]:
    if isinstance(names, str):
        names = [names]
    dicts = []
    for name in names:
        dicts.extend(DatasetCatalog.get(name))
    return dicts


def _resolve_shard(shard_id: Optional[int], num_shards: Optional[int]):
    """One shard of one. The layout is the caller's to name (the reference's
    per-rank DataLoader, `slender_det/engine/defaults.py:66`, takes it from
    the process group), and more than one shard is not ported: the globally
    formed batches and the strided test subsets come with data-parallel
    training."""
    if num_shards is None:
        return 0, 1
    if num_shards != 1 or (shard_id or 0) != 0:
        raise NotImplementedError(
            f"shard {shard_id} of {num_shards}: sharded loaders are not "
            "ported; they come with data-parallel training (DDP)")
    return 0, 1


def build_detection_train_loader(cfg, mapper: Optional[DatasetMapper] = None,
                                 seed: int = 0,
                                 shard_id: Optional[int] = None,
                                 num_shards: Optional[int] = None):
    """Infinite iterator of fixed-shape batches, bucketed by orientation.
    One shard of one: `_resolve_shard` raises for any other layout."""
    dataset_dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN)
    if cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS:
        dataset_dicts = [d for d in dataset_dicts if d.get("annotations")]
    mapper = mapper or DatasetMapper(cfg, is_train=True)
    batch_size = cfg.SOLVER.IMS_PER_BATCH

    sampler_name = cfg.DATALOADER.SAMPLER_TRAIN
    if sampler_name == "TrainingSampler":
        sampler = training_sampler(len(dataset_dicts), seed=seed)
    elif sampler_name == "RatioFactorTrainingSampler":
        sampler = repeat_factor_sampler(
            repeat_factors_from_ratios(dataset_dicts), seed=seed
        )
    elif sampler_name == "RepeatFactorTrainingSampler":
        # frequency-based; approximated with ratio factors' mechanism using
        # category frequencies
        from collections import Counter

        counts: Counter = Counter()
        for d in dataset_dicts:
            for a in d.get("annotations", []):
                counts[a["category_id"]] += 1
        total = sum(counts.values()) or 1
        thresh = cfg.DATALOADER.REPEAT_THRESHOLD
        factors = []
        for d in dataset_dicts:
            f = 1.0
            for a in d.get("annotations", []):
                freq = counts[a["category_id"]] / total
                if freq > 0:
                    f = max(f, np.sqrt(thresh / freq) if freq < thresh else 1.0)
            factors.append(f)
        sampler = repeat_factor_sampler(np.array(factors), seed=seed)
    else:
        raise ValueError(f"Unknown sampler {sampler_name!r}")

    num_workers = cfg.DATALOADER.NUM_WORKERS
    _resolve_shard(shard_id, num_shards)

    def gen():
        if num_workers > 1:
            examples = mp_map_stream(dataset_dicts, mapper, sampler,
                                     num_workers, seed=seed + 1)
        else:
            g = np.random.default_rng(seed + 1)
            examples = (mapper(dataset_dicts[idx], rng=g) for idx in sampler)
        buckets: Dict[bool, List[Dict]] = {True: [], False: []}
        for ex in examples:
            is_landscape = ex["image"].shape[1] >= ex["image"].shape[0]
            buckets[is_landscape].append(ex)
            if len(buckets[is_landscape]) == batch_size:
                yield _stack_batch(buckets[is_landscape])
                buckets[is_landscape] = []

    return _Prefetcher(gen())


def build_detection_test_loader(cfg, dataset_name: str, batch_size: int = 1,
                                mapper: Optional[DatasetMapper] = None,
                                shard_id: Optional[int] = None,
                                num_shards: Optional[int] = None):
    """Finite iterator over the test set; groups consecutive same-bucket
    images, padding the final partial batch with repeats + a validity list.
    One shard of one: `_resolve_shard` raises for any other layout."""
    dataset_dicts = get_detection_dataset_dicts(dataset_name)
    _resolve_shard(shard_id, num_shards)
    mapper = mapper or DatasetMapper(cfg, is_train=False)
    num_workers = cfg.DATALOADER.NUM_WORKERS

    def gen():
        if num_workers > 1:
            examples = mp_map_stream(dataset_dicts, mapper,
                                     range(len(dataset_dicts)), num_workers)
        else:
            g = np.random.default_rng(0)
            examples = (mapper(d, rng=g) for d in dataset_dicts)
        buckets: Dict[bool, List[Dict]] = {True: [], False: []}
        for ex in examples:
            is_landscape = ex["image"].shape[1] >= ex["image"].shape[0]
            buckets[is_landscape].append(ex)
            if len(buckets[is_landscape]) == batch_size:
                batch = _stack_batch(buckets[is_landscape])
                batch["batch_valid"] = [True] * batch_size
                yield batch
                buckets[is_landscape] = []
        for remaining in buckets.values():
            if remaining:
                n = len(remaining)
                while len(remaining) < batch_size:
                    remaining.append(remaining[-1])
                batch = _stack_batch(remaining)
                batch["batch_valid"] = [True] * n + [False] * (batch_size - n)
                yield batch

    return _Prefetcher(gen())
