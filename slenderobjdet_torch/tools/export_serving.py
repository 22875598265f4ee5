"""Export a detector as a serving artifact, loadable without the
model-building code (counterpart of ``tools/export_serving.py``; see
``slenderobjdet_torch/serving.py``).

    python -m slenderobjdet_torch.tools.export_serving \\
        --config configs/fcos/fcos_R_50_FPN_1x.yaml --output /tmp/fcos_serving \\
        [--weights model_final.pth] [--batch 8] [--device cuda] [--quantize] \\
        [--int8 [--int8-scales configs/int8_scales/fcos_R_50_bench.json]] \\
        [--verify] [KEY VALUE ...]

The program takes the config's ``TPU.TEST_PAD_SHAPE`` (trailing ``KEY
VALUE`` pairs override the config, for example ``TPU.TEST_PAD_SHAPE
"(896, 1408)"``, the loader's landscape bucket). ``--quantize`` stores the
conv and linear weights as per-channel int8 (weight-only: the program
dequantizes them); ``--int8`` bakes the int8 compute of
``TPU.INT8_PREDICT`` (``ops/quant.py``) into the program, with the static
calibrated scales of ``--int8-scales`` where given. ``--verify`` reloads the
artifact and compares one predict of random images with the live model's,
within the JAX tool's tolerances. Without ``--device`` the model is built on
the card.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

FIELDS = ("boxes", "scores", "classes", "valid")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--weights", default="",
                    help="a checkpoint of this package (.pth) or a detectron2 .pkl")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; the program runs on that device type")
    ap.add_argument("--quantize", action="store_true",
                    help="weight-only per-channel int8 (the program dequantizes)")
    ap.add_argument("--int8", action="store_true",
                    help="TPU.INT8_PREDICT: the int8 compute path baked into the program "
                         "(ops/quant.py); distinct from --quantize, which only shrinks "
                         "the stored weights")
    ap.add_argument("--int8-scales", default="",
                    help="calibrated activation scales JSON (tools/int8_calibrate.py); "
                         "with --int8, the static-scale int8 path")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and compare one predict")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE pairs that override the config")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The config and the model (weights from ``--weights``, else drawn from
    seed 0) that ``args`` name."""
    from ..checkpoint.checkpointer import load_model_weights
    from ..config import get_cfg
    from ..models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.int8:
        cfg.TPU.INT8_PREDICT = True
    if args.int8_scales:
        cfg.TPU.INT8_SCALES = args.int8_scales
    cfg.freeze()
    model = build_model(cfg, device=args.device)
    if args.weights:
        load_model_weights(args.weights, model)
    return cfg, model


def random_batch(batch_size: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """The JAX tool's verification batch: uniform uint8 images, scale 1."""
    r = np.random.RandomState(0)
    return {"image": r.randint(0, 255, (batch_size, h, w, 3)).astype(np.uint8),
            "scale": np.full((batch_size,), 1.0, np.float32),
            "orig_size": np.asarray([[h, w]] * batch_size, np.float32)}


def verify_outputs(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   quantize: bool) -> None:
    """The artifact's detections against the live model's, with the JAX
    tool's tolerances: rtol 1e-5 and atol 1e-5 in float32; with ``quantize``,
    atol 2.0 on the boxes and 0.05 on the rest."""
    for k in FIELDS:
        atol = (2.0 if k == "boxes" else 0.05) if quantize else 1e-5
        np.testing.assert_allclose(out[k].float().cpu().numpy(), ref[k].float().cpu().numpy(),
                                   rtol=1e-5, atol=atol, err_msg=k)


def main(argv: Optional[List[str]] = None) -> int:
    from ..serving import export_detector, load_detector

    args = parse_args(argv)
    cfg, model = build(args)
    h, w = cfg.TPU.TEST_PAD_SHAPE
    t0 = time.perf_counter()
    export_detector(model, args.output, batch_size=args.batch, image_hw=(h, w),
                    quantize=args.quantize)
    print(f"exported {args.config} (batch={args.batch}, {h}x{w}, "
          f"{'int8 compute, ' if args.int8 else ''}"
          f"{'int8 weights' if args.quantize else 'float32 weights'}) -> {args.output} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.verify:
        predict_fn = load_detector(args.output)
        batch = random_batch(args.batch, h, w)
        verify_outputs(predict_fn(batch), model.predict(batch), args.quantize)
        print("verify: artifact == model.predict OK"
              + (" (int8 tolerance)" if args.quantize else ""), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
