"""Multi-process helpers over ``torch.distributed`` (counterpart of
``slenderobjdet_tpu/parallel/multihost.py``).

The reference trains data-parallel: one process per GPU under NCCL DDP,
started by detectron2's ``launch`` (``train_net.py:188-195``,
``train_multi_nodes.sh``), with host-side collectives for the evaluation's
gather and barriers around checkpoints. The port does the same; the
processes are started by ``parallel/launch.py``.

Every helper is a pass-through when no process group is initialised, as the
JAX helpers are when ``jax.process_count() == 1``, so the single-process
paths are unchanged.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List

import torch
import torch.distributed as dist

__all__ = [
    "process_count",
    "process_index",
    "is_main_process",
    "all_gather_objects",
    "sync_processes",
    "global_sum",
    "sum_over_processes",
    "gather_over_processes",
    "process_share",
    "global_normalizer",
    "global_quotient",
    "mean_over_processes",
    "state_digest",
]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object a process; every process receives the list
    ordered by rank (the reference's ``comm.gather``,
    ``coco_evaluation.py:82-84``, made symmetric as the JAX helper is)."""
    if not _initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def sync_processes() -> None:
    """A barrier across processes (reference ``comm.synchronize``). No-op
    with no group."""
    if not _initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (a tensor without gradient, a count) over the
    processes; ``x`` itself with no group. The losses' counts are these
    global sums: the JAX program sees the whole batch, so its normalisers
    are counts over the global batch."""
    x = x.detach()
    if not _initialized():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def sum_over_processes(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes WITH its gradient (trainable
    BatchNorm's batch statistics): the backward all-reduces the gradient
    too, so each process's activations receive every process's terms.
    ``x`` itself with no group. Unlike ``torch.nn.SyncBatchNorm``'s
    reduction it runs on CPU tensors, under gloo."""
    if not _initialized():
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def gather_over_processes(x: torch.Tensor) -> torch.Tensor:
    """The processes' ``x`` (each the same shape, no gradient) concatenated
    along dim 0 in rank order, which is the joined batch's order when ``x``
    holds a process's rows; ``x`` itself with no group."""
    x = x.detach()
    if not _initialized():
        return x
    dev = x.device
    if dist.get_backend() == "gloo":        # gloo gathers host tensors only
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(out, x.contiguous())
    return torch.cat(out).to(dev)


def process_share(n: torch.Tensor) -> torch.Tensor:
    """What one process divides its local sum by when the loss is that sum
    over the global batch divided by ``n``, a normaliser of the global
    batch (the same on every process): ``n / process_count()``.
    Data-parallel training averages the processes' gradients, so the mean
    over the processes of ``local_sum / share`` is ``global_sum / n``: its
    gradient is the JAX loss's on the joined batch, however the count is
    split. With no group it is ``n`` bit for bit."""
    return n / process_count()


def global_normalizer(count: torch.Tensor, floor: float):
    """``(n, share)`` for a loss normalised by a count of the batch:
    ``n = max(global_sum(count), floor)``, the JAX program's normaliser,
    and ``share = process_share(n)``."""
    n = torch.clamp(global_sum(count), min=floor)
    return n, process_share(n)


def global_quotient(num: torch.Tensor, den: torch.Tensor, floor: float) -> torch.Tensor:
    """A process's share of ``sum(num) / max(sum(den), floor)`` over the
    processes, where the normaliser ``den`` carries a gradient (FCOSAnchor's
    sum of shape weights): the mean over the processes of the value and of
    its gradient are those of the quotient of the global sums. With no group
    it is the plain quotient, bit for bit."""
    if not _initialized():
        return num / torch.clamp(den, min=floor)
    w = process_count()
    den_g = torch.clamp(global_sum(den), min=floor)
    coeff = global_sum(num) / (den_g * den_g) * w
    # the second term is zero in value; its gradient is the quotient's
    # through the global denominator
    return num / (den_g / w) - coeff * (den - den.detach())


def mean_over_processes(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar tensors averaged over the processes by one all-reduce of their
    stack, as floats; with no group, each tensor's own value."""
    if not _initialized():
        return {k: float(v) for k, v in metrics.items()}
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().reshape(()).double() for k in keys])
    dist.all_reduce(stacked)
    stacked /= process_count()
    return dict(zip(keys, stacked.tolist()))


def state_digest(module: torch.nn.Module) -> str:
    """A SHA-256 of ``module``'s state (names and bytes), to hold the
    processes' replicas bit-equal."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
