"""Start one process per device and a process group among them: the
counterpart of detectron2's ``launch``, which the reference calls at
``train_net.py:188-195``.

    launch(main_func, num_gpus_per_machine, num_machines=1, machine_rank=0,
           dist_url="auto", args=())

runs ``main_func(*args)`` in ``num_gpus_per_machine`` processes on each of
``num_machines`` machines, rank ``machine_rank * num_gpus_per_machine +
local_rank``, and returns this machine's return values in local-rank order.
One process in all (and no ``force_group``) runs ``main_func`` in the
calling process with no process group. Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) the
calling process is already one rank: it joins the group and runs
``main_func`` itself.

On a machine with a card each process takes ``cuda:<local_rank>`` as its
current device before ``main_func`` runs, so that every model, tensor and
kernel launch of the rank lands there. This is the only place that sets it.
The backend is ``nccl`` on the card and ``gloo`` on the CPU; gloo ranks may
share a card (``local_rank`` modulo the device count), NCCL ranks may not.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .multihost import sync_processes

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

__all__ = ["DEFAULT_TIMEOUT", "launch"]


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _set_device(local_rank: int, backend: str) -> None:
    if not torch.cuda.is_available():
        return
    count = torch.cuda.device_count()
    if backend == "nccl":
        assert local_rank < count, (
            f"local rank {local_rank} has no card of its own: {count} visible")
    torch.cuda.set_device(local_rank % count)


def _run_rank(local_rank: int, main_func: Callable, args: Sequence, world_size: int,
              num_gpus_per_machine: int, machine_rank: int, dist_url: str, backend: str,
              timeout: datetime.timedelta, result_dir: str) -> None:
    _set_device(local_rank, backend)
    rank = machine_rank * num_gpus_per_machine + local_rank
    if isinstance(dist_url, int):   # the port of the parent's store
        store = dist.TCPStore("127.0.0.1", dist_url, world_size, is_master=False,
                              timeout=timeout)
        dist.init_process_group(backend=backend, store=store, world_size=world_size,
                                rank=rank, timeout=timeout)
    else:
        dist.init_process_group(backend=backend, init_method=dist_url,
                                world_size=world_size, rank=rank, timeout=timeout)
    try:
        result = main_func(*args)
        sync_processes()    # no rank tears the group down while another joins it
    finally:
        dist.destroy_process_group()
    # a file, not a queue: a child blocked on a full pipe would never exit
    with open(os.path.join(result_dir, f"rank{local_rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _torchrun_rank(main_func: Callable, args: Sequence, backend: Optional[str],
                   timeout: datetime.timedelta) -> List[Any]:
    backend = backend or default_backend()
    _set_device(int(os.environ["LOCAL_RANK"]), backend)
    dist.init_process_group(backend=backend, init_method="env://", timeout=timeout)
    try:
        result = main_func(*args)
        sync_processes()
        return [result]
    finally:
        dist.destroy_process_group()


def launch(main_func: Callable, num_gpus_per_machine: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", args: Sequence = (),
           backend: Optional[str] = None, timeout: datetime.timedelta = DEFAULT_TIMEOUT,
           join_timeout: Optional[float] = None, force_group: bool = False) -> List[Any]:
    """Run ``main_func(*args)`` on every local rank; returns their results,
    which must pickle, in local-rank order. ``timeout`` bounds each
    collective, so a rank that dies cannot hang the others; ``join_timeout``
    (seconds) bounds the whole run, after which every rank is killed and
    TimeoutError raised. ``force_group`` gives one process a group of one."""
    if all(k in os.environ for k in _TORCHRUN_ENV):
        return _torchrun_rank(main_func, args, backend, timeout)
    world_size = num_machines * num_gpus_per_machine
    if world_size == 1 and not force_group:
        return [main_func(*args)]
    store = None
    if dist_url == "auto":
        assert num_machines == 1, "dist_url=auto is for one machine; name the main rank's address"
        # the rendezvous store lives here, on a port the system picks and
        # this process holds, so that concurrent launches cannot collide
        store = dist.TCPStore("127.0.0.1", 0, world_size, is_master=True,
                              wait_for_workers=False, timeout=timeout)
        dist_url = store.port
    backend = backend or default_backend()

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="slenderobjdet_launch_") as result_dir:
        context = mp.start_processes(
            _run_rank, nprocs=num_gpus_per_machine, join=False, start_method="spawn",
            args=(main_func, tuple(args), world_size, num_gpus_per_machine, machine_rank,
                  dist_url, backend, timeout, result_dir))
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        try:
            while not context.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch: {num_gpus_per_machine} ranks still running after "
                        f"{join_timeout} s")
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        del store
        results = []
        for local_rank in range(num_gpus_per_machine):
            with open(os.path.join(result_dir, f"rank{local_rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
