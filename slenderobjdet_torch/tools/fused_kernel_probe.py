"""Bisection probe of the fused-bottleneck CUDA kernel: times variants of
the bf16 wgmma path ``fused_bottleneck`` runs, each with one part stripped,
on R-50 stride-1 block shapes at 800x1344: res2_1 (the TPU probe's shape),
res4_1 and res5_1 (port of ``tools/fused_kernel_probe.py``).

    python -m slenderobjdet_torch.tools.fused_kernel_probe [--batch 32]
        [--th 32] [--modes cudnn,full,norolls,notap,noconv2,dmaonly,nodma]

Modes (``ops/fused_bottleneck.py:probe_variant``): ``full`` is the kernel
the model runs; ``norolls`` drops the 3x3 conv's column shift; ``notap``
keeps the centre tap; ``noconv2`` skips conv2; ``dmaonly`` streams x in and
writes the output; ``nodma`` writes the output alone. ``cudnn`` is the same
block as three bf16 cuDNN convolutions (the TPU probe's ``xla`` mode). The
wrapper picks the tiles by shape (``ops/fused_bottleneck.py:
bottleneck_plan``), so ``--th``, the TPU tile's rows, is accepted and not
used. Times are CUDA events; GB/s counts one read
of x and one write of the output.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_bottleneck import PROBE_MODES, probe_variant
from .card import card_line, cuda_ms, require_card

# name: H, W, Cin, Cm, Cout of R-50's identity blocks at 800x1344
BLOCKS = {
    "res2_1": (200, 336, 256, 64, 256),
    "res4_1": (50, 84, 1024, 256, 1024),
    "res5_1": (25, 42, 2048, 512, 2048),
}


def block_inputs(batch, h, w, cin, cm, cout, dev, seed=0):
    """x (B, H, W, Cin) bf16 and folded weights (w1, b1, w2, b2, w3, b3):
    bf16 weights with fan-in scale from a numpy seed, fp32 biases."""
    rs = np.random.RandomState(seed)

    def wt(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return torch.tensor(rs.randn(*shape).astype(np.float32) / fan_in ** 0.5,
                            device=dev).to(torch.bfloat16)

    def bias(n):
        return torch.tensor(rs.randn(n).astype(np.float32) * 0.1, device=dev)

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(batch, h, w, cin, generator=g, device=dev)
                   ).to(torch.bfloat16)
    return x, (wt(cin, cm), bias(cm), wt(3, 3, cm, cm), bias(cm),
               wt(cm, cout), bias(cout))


def cudnn_block(x, w1, b1, w2, b2, w3, b3):
    """The block as bf16 cuDNN convolutions on channels-last NCHW."""
    def conv(v, w, b, pad):
        return F.conv2d(v, w.permute(3, 2, 0, 1), b.to(v.dtype), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    a1 = torch.relu(conv(xc, w1[None, None], b1, 0))
    a2 = torch.relu(conv(a1, w2, b2, 1))
    return torch.relu(conv(a2, w3[None, None], b3, 0) + xc).permute(0, 2, 3, 1)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--th", type=int, default=32)
    ap.add_argument("--modes", default="cudnn," + ",".join(PROBE_MODES))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = require_card()
    print(card_line(), flush=True)
    results = []
    for name, (h, w, cin, cm, cout) in BLOCKS.items():
        x, weights = block_inputs(args.batch, h, w, cin, cm, cout, dev)
        gb = 2 * x.numel() * x.element_size() / 1e9
        print(f"{name} identity block B={args.batch} {h}x{w} "
              f"{cin}->{cm}->{cout} bf16", flush=True)
        for mode in args.modes.split(","):
            if mode == "cudnn":
                fn = lambda: cudnn_block(x, *weights)          # noqa: E731
            else:
                fn = lambda m=mode: probe_variant(m, x, *weights)  # noqa: E731
            ms = cuda_ms(fn, args.iters)
            gbps = gb / (ms / 1e3)
            results.append({"block": name, "mode": mode, "ms": ms,
                            "gbps": gbps})
            print(f"  {mode:10s} {ms:9.4f} ms  {gbps:8.1f} GB/s", flush=True)
        del x, weights
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
