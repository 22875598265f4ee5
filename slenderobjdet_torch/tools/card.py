"""What the measurement scripts share (the probe tools and ``chip_smoke.py``):
the card check, its ``nvidia-smi`` line, and CUDA-event timing."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA's published HBM3 bandwidth of the H100 SXM (data sheet), the
# ceiling the bandwidth probes are read against; a spec, not a measurement.
H100_SXM_PEAK_GBPS = 3350.0


def require_card() -> torch.device:
    """The first CUDA device; a probe measures the card or fails."""
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def card_line() -> str:
    """``name, power.limit`` as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches after warm-up,
    from CUDA events. ``queued`` holds the stream back for about 10 ms first,
    so that every launch is enqueued before the first one runs: the time of
    a kernel shorter than its own enqueue, not the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)      # device clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
