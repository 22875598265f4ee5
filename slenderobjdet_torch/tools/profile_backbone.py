"""Per-stage throughput profile of the flagship FCOS R-50-FPN inference path
(counterpart of ``tools/profile_backbone.py``: the same flags, sizes, rows
and columns).

    python -m slenderobjdet_torch.tools.profile_backbone [--batch 32] [--reps 8]
        [--fused] [--device cuda|cpu]

Rows, on zero inputs of B x 800 x 1344 in bf16, weights drawn from seed 0:

- ``stem(norm+7x7+pool)``: ``Stem``, the JAX script's plain stem (normalise
  by 110 / 57, a 7x7/2 convolution to 64 channels, relu, a 3x3/2 max pool)
  through cuDNN;
- ``res2``-``res5``: ``Stage``, an R-50 stage's bottleneck blocks
  (``BottleneckBlock``) on its input shape. With ``--fused`` every stride-1
  block runs the ``fused_bottleneck`` kernel: 3, 3, 5 and 2 launches a call;
- ``full-resnet50``: ``ResNet`` (res3-res5 out; 13 kernel launches with
  ``--fused``);
- ``backbone+FPN(graph)``, ``fwd(backbone+head)``, ``predict(full)``: the
  flagship FCOS (``configs/fcos/fcos_R_50_FPN_1x.yaml`` with
  ``MODEL.RESNETS.FUSED_BLOCKS`` as ``--fused``; predict launches the NMS
  kernel once a call).

GFLOP/img counts the stem's and the blocks' convolutions (``stage_flops``),
TFLOPS is that over the measured time. Each row is called once and then
``--reps`` times back to back (``tools/_profile.py``); the first line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbones.resnet import BottleneckBlock, ResNet
from ..models.layers import Conv2d
from ._profile import (StageTimer, add_device_arg, conv_flops, device_line, device_of,
                       load_cfg, predict_batch, seeded_model, seeded_module)

CONFIG = "configs/fcos/fcos_R_50_FPN_1x.yaml"
OVERRIDES: List[str] = []           # KEY VALUE pairs over the yaml
HW = (800, 1344)
DTYPE = torch.bfloat16
STEM_CHANNELS = 64
PIXEL_MEAN, PIXEL_STD = 110.0, 57.0


def stage_specs(h: int, w: int):
    """(name, blocks, in, bottleneck, out channels, input (h, w), stride) of
    R-50's four stages at an h x w image."""
    return [
        ("res2", 3, 64, 64, 256, (h // 4, w // 4), 1),
        ("res3", 4, 256, 128, 512, (h // 4, w // 4), 2),
        ("res4", 6, 512, 256, 1024, (h // 8, w // 8), 2),
        ("res5", 3, 1024, 512, 2048, (h // 16, w // 16), 2),
    ]


def stem_flops(h: int, w: int) -> int:
    return conv_flops((h // 2) * (w // 2), 3, STEM_CHANNELS, 7)


def stage_flops(n: int, cin: int, mid: int, cout: int, ho: int, wo: int) -> int:
    """A stage's convolutions at its output size: the first block with its
    shortcut, then n - 1 identity blocks."""
    f = conv_flops(ho * wo, cin, mid) + conv_flops(ho * wo, mid, mid, 3) \
        + conv_flops(ho * wo, mid, cout) + conv_flops(ho * wo, cin, cout)
    f += (n - 1) * (conv_flops(ho * wo, cout, mid) + conv_flops(ho * wo, mid, mid, 3)
                    + conv_flops(ho * wo, mid, cout))
    return f


class Stem(nn.Module):
    """The JAX script's stem: NHWC images in, NCHW (channels-last memory)
    features out."""

    def __init__(self, out_channels: int = STEM_CHANNELS):
        super().__init__()
        self.conv = Conv2d(3, out_channels, 7, 2, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ((x - PIXEL_MEAN) / PIXEL_STD).permute(0, 3, 1, 2)
        return F.max_pool2d(F.relu(self.conv(x)), 3, stride=2, padding=1)


class Stage(nn.Module):
    """``n`` FrozenBN bottleneck blocks named ``{name}_{i}`` as in
    ``ResNet``, the first with ``stride``; NCHW in and out."""

    def __init__(self, name: str, n: int, cin: int, mid: int, cout: int, stride: int,
                 fused: bool):
        super().__init__()
        for i in range(n):
            self.add_module(f"{name}_{i}", BottleneckBlock(
                cin if i == 0 else cout, cout, mid, stride=stride if i == 0 else 1,
                norm="FrozenBN", fused=fused))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


def nchw_zeros(batch: int, h: int, w: int, c: int, dev) -> torch.Tensor:
    """Zeros (B, C, H, W) in channels-last memory, the trunk's layout."""
    return torch.zeros((batch, h, w, c), dtype=DTYPE, device=dev).permute(0, 3, 1, 2)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--fused", action="store_true",
                    help="run stride-1 bottlenecks through the fused CUDA kernel "
                         "(MODEL.RESNETS.FUSED_BLOCKS)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B, K = args.batch, args.reps
    H, W = HW
    timer = StageTimer(dev, K)
    rows = []

    def bench(name, module, x, flops_per_img):
        module = seeded_module(module, dev)
        ms = timer(name, lambda: module(x))
        rows.append((name, ms, flops_per_img / 1e9, flops_per_img * B / ms / 1e9))

    total_f = stem_flops(H, W)
    bench("stem(norm+7x7+pool)", Stem(),
          torch.zeros((B, H, W, 3), dtype=DTYPE, device=dev), total_f)
    for name, n, cin, mid, cout, (h, w), s in stage_specs(H, W):
        f = stage_flops(n, cin, mid, cout, h // s, w // s)
        total_f += f
        bench(name, Stage(name, n, cin, mid, cout, s, args.fused),
              nchw_zeros(B, h, w, cin, dev), f)
    bench("full-resnet50",
          ResNet(depth=50, norm="FrozenBN", fused_blocks=args.fused,
                 out_features=("res3", "res4", "res5")),
          nchw_zeros(B, H, W, 3, dev), total_f)

    # --- flagship graph pieces
    cfg = load_cfg(CONFIG, [*OVERRIDES, "MODEL.RESNETS.FUSED_BLOCKS", str(args.fused)])
    model = seeded_model(cfg, dev)
    x = torch.zeros((B, H, W, 3), dtype=DTYPE, device=dev)
    batch = predict_batch(B, (H, W), dev)
    for name, fn in (("backbone+FPN(graph)", lambda: model.backbone(x.permute(0, 3, 1, 2))),
                     ("fwd(backbone+head)", lambda: model(x)),
                     ("predict(full)", lambda: model.predict(batch))):
        rows.append((name, timer(name, fn), 0, 0))

    dt = str(DTYPE).removeprefix("torch.")
    print(f"\nB={B} {H}x{W} {dt} — 1 warm-up call, then {K} back-to-back calls, "
          "ms per execution")
    print(f"{'stage':24s} {'ms':>9s} {'GFLOP/img':>10s} {'TFLOPS':>8s}")
    for name, ms, gf, tf in rows:
        print(f"{name:24s} {ms:9.2f} {gf:10.1f} {tf:8.1f}")
    return timer.result()


if __name__ == "__main__":
    main()
