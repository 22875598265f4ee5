"""Data-parallel training over ``torch.distributed`` (counterpart of
``slenderobjdet_tpu/parallel/``): ``launch`` starts one process per device,
``multihost`` holds the helpers every rank calls. The JAX package's mesh
(``parallel/mesh.py``) has no counterpart: DDP takes its data axis, and its
model and spatial axes are not ported."""

from .launch import launch
from .multihost import (all_gather_objects, global_normalizer, global_sum, is_main_process,
                        mean_over_processes, process_count, process_index, process_share,
                        state_digest, sync_processes)

__all__ = ["launch", "all_gather_objects", "global_normalizer", "global_sum",
           "is_main_process", "mean_over_processes", "process_count", "process_index",
           "process_share", "state_digest", "sync_processes"]
