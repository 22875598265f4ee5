"""Read-bandwidth probe: does splitting each copy of a tile into N
concurrent bulk asynchronous copies raise the read bandwidth? (port of
``tools/dma_streams_probe.py``).

    python -m slenderobjdet_torch.tools.dma_streams_probe [--batch 32]
        [--th 40] [--streams 1,2,4,8]

Each block of ``csrc/dma_streams_probe.cu`` reads one (th, 336, 256) bf16
tile of a (B, 200, 336, 256) tensor through shared memory and writes an
(8, 128) token. Times are CUDA events; GB/s counts the bytes of the tiles
read, against the H100 SXM's published 3.35 TB/s.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops.dma_streams_probe import dma_streams
from .card import H100_SXM_PEAK_GBPS, card_line, cuda_ms, require_card

SHAPE = (200, 336, 256)
ITERS = 10


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--th", type=int, default=40)
    ap.add_argument("--streams", default="1,2,4,8")
    args = ap.parse_args(argv)
    dev = require_card()
    print(card_line(), flush=True)
    h, w, c = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch, h, w, c, generator=g, device=dev,
                    dtype=torch.bfloat16)
    gb = args.batch * (h // args.th) * args.th * w * c * x.element_size() / 1e9
    print(f"read {args.batch}x{h}x{w}x{c} bf16 tiles th={args.th}, N "
          f"concurrent bulk copies; ceiling {H100_SXM_PEAK_GBPS:.0f} GB/s "
          f"(H100 SXM spec)", flush=True)
    results = []
    for n in (int(s) for s in args.streams.split(",")):
        ms = cuda_ms(lambda: dma_streams(x, args.th, n), ITERS)
        gbps = gb / (ms / 1e3)
        results.append({"streams": n, "ms": ms, "gbps": gbps})
        print(f"streams={n:2d} {ms:9.4f} ms  {gbps:8.1f} GB/s "
              f"({gbps / H100_SXM_PEAK_GBPS:.3f} of spec)", flush=True)
    return results


if __name__ == "__main__":
    main()
