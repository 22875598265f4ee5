"""Calibrate static int8 activation scales for a config's predict path
(counterpart of ``tools/int8_calibrate.py``).

Runs N batches through ``model.predict`` in full precision, recording each
static-eligible conv's input max-abs (``ops/quant.py:traced_calibration``,
or ``calibration_scope`` with ``--eager``), and writes ``{module/path:
amax}`` JSON for ``TPU.INT8_SCALES``, keyed by the Flax paths the JAX
package's file uses.

Calibration data: a registered dataset's test loader (``--dataset``), or
synthetic uniform uint8 images from a seed (the default: enough for a
timing run; calibrate on real images before trusting AP).

    python -m slenderobjdet_torch.tools.int8_calibrate \\
        configs/fcos/fcos_R_50_FPN_1x.yaml out_scales.json [--batches 8] \\
        [--batch 4] [--dataset NAME] [--weights model_final.pth] \\
        [--device cuda] [--opts KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def synthetic_batches(cfg, n_batches: int, batch_size: int, seed: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    h, w = cfg.TPU.TEST_PAD_SHAPE
    r = np.random.RandomState(seed)
    for _ in range(n_batches):
        yield {
            "image": r.randint(0, 255, (batch_size, h, w, 3)).astype(np.uint8),
            "scale": np.full((batch_size,), 800.0 / 1333.0, np.float32),
            "orig_size": np.asarray([[1333, 2000]] * batch_size, np.float32),
            "image_size": np.asarray([[h, w]] * batch_size, np.int32),
        }


def dataset_batches(cfg, name: str, n_batches: int, batch_size: int):
    from ..data import build_detection_test_loader

    loader = build_detection_test_loader(cfg, name, batch_size=batch_size)
    for i, batch in enumerate(loader):
        if i >= n_batches:
            return
        yield {k: batch[k] for k in ("image", "scale", "orig_size", "image_size")
               if k in batch}


def calibrate(model, batches, eager: bool = False, log=None) -> Dict[str, float]:
    """{conv path: the largest input max-abs over ``batches``}."""
    from ..ops.quant import calibration_scope, traced_calibration

    sink: Dict[str, float] = {}
    if eager:
        with calibration_scope(sink):
            for i, batch in enumerate(batches):
                model.predict(batch)
                if log:
                    log(f"batch {i + 1}: {len(sink)} conv sites recorded")
        return sink
    calib = traced_calibration(model.predict)
    for i, batch in enumerate(batches):
        _, amaxes = calib(batch)
        for k, v in amaxes.items():
            sink[k] = max(sink.get(k, 0.0), float(v))
        if log:
            log(f"batch {i + 1}: {len(sink)} conv sites recorded")
    return sink


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("out", help="output scales JSON")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dataset", default="",
                    help="registered dataset for real calibration images")
    ap.add_argument("--weights", default="",
                    help="checkpoint to calibrate (default: weights from seed 0)")
    ap.add_argument("--margin", type=float, default=1.0,
                    help="multiply recorded amax by this safety factor")
    ap.add_argument("--eager", action="store_true",
                    help="record host floats conv by conv (calibration_scope) instead "
                         "of one fetch a batch (traced_calibration)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from ..checkpoint.checkpointer import load_model_weights
    from ..config import get_cfg
    from ..models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    model = build_model(cfg, device=args.device)
    if cfg.MODEL.WEIGHTS:
        load_model_weights(cfg.MODEL.WEIGHTS, model)
    batches = (dataset_batches(cfg, args.dataset, args.batches, args.batch)
               if args.dataset else synthetic_batches(cfg, args.batches, args.batch))
    sink = calibrate(model, batches, args.eager,
                     log=lambda m: print(m, file=sys.stderr))
    scales = {k: v * args.margin for k, v in sorted(sink.items())}
    with open(args.out, "w") as f:
        json.dump(scales, f, indent=1)
    print(f"wrote {len(scales)} scales to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
