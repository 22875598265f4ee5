"""Copy-bandwidth probe: ``y = x * 0.5`` over a bf16 (B, 200, 336, 256)
tensor (the res2 activation at 800x1344), by the hand-written kernel with
full-row or 128-channel-sliced stores, against PyTorch's own elementwise
kernel (port of ``tools/pallas_bw_probe.py``).

    python -m slenderobjdet_torch.tools.bw_probe [--batch 32] [--th 32]
        [--modes torch,blocked,chunked]

Modes: ``torch`` is ``x * 0.5`` in PyTorch (the TPU probe's ``xlacopy``);
``blocked`` and ``chunked`` are ``csrc/bw_probe.cu``. th rows of one image
are the unit that is cut into chunks of at most 16 KB, and the grid is one
CTA a chunk. Times are CUDA events; GB/s counts one read and one write of
x, against the H100 SXM's published 3.35 TB/s.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops.bw_probe import bw_copy, reference_copy
from .card import H100_SXM_PEAK_GBPS, card_line, cuda_ms, require_card

SHAPE = (200, 336, 256)
ITERS = 10


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--th", type=int, default=32)
    ap.add_argument("--modes", default="torch,blocked,chunked")
    args = ap.parse_args(argv)
    dev = require_card()
    print(card_line(), flush=True)
    h, w, c = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch, h, w, c, generator=g, device=dev,
                    dtype=torch.bfloat16)
    gb = 2 * x.numel() * x.element_size() / 1e9
    print(f"copy {args.batch}x{h}x{w}x{c} bf16, th={args.th}; ceiling "
          f"{H100_SXM_PEAK_GBPS:.0f} GB/s (H100 SXM spec)", flush=True)
    results = []
    for mode in args.modes.split(","):
        if mode == "torch":
            fn = lambda: reference_copy(x)           # noqa: E731
        else:
            fn = lambda m=mode: bw_copy(x, args.th, m)   # noqa: E731
        ms = cuda_ms(fn, ITERS)
        gbps = gb / (ms / 1e3)
        results.append({"mode": mode, "ms": ms, "gbps": gbps})
        print(f"{mode:10s} {ms:9.4f} ms  {gbps:8.1f} GB/s "
              f"({gbps / H100_SXM_PEAK_GBPS:.3f} of spec)", flush=True)
    return results


if __name__ == "__main__":
    main()
