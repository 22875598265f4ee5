"""Evaluate a detector on Objects365 with the 365 -> COCO-80 class mapping
and dump its COCO-format results chunk by chunk (counterpart of
``tools/inference_obj365.py``; the same flags and output files).

    python -m slenderobjdet_torch.tools.inference_obj365 --config-file configs/fcos/... \\
        --gt-json obj365_val.json --image-root images/ [--weights ckpt.pth] \\
        [--out-dir obj365_out] [--max-images N] [--batch-size 4] [--chunk 500] \\
        [--device cpu] [KEY VALUE ...]

Writes ``results_chunk_<k>.json`` every ``--chunk`` images,
``coco_instances_results.json`` and the AR matrix (the evaluator's files) and
``obj365_metrics.json``. PNG images are decoded without cv2. Without
``--device`` the model runs on the card: the FCOS R-50-FPN flagship with its
fused flags launches 1 stem, 13 bottleneck and 1 NMS kernel a batch.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from ._common import PNGReadingMapper, add_model_args, build_and_load, load_cfg, to_numpy

DATASET = "_obj365_inference"
INPUT_KEYS = ("image", "scale", "orig_size", "image_size")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--out-dir", default="obj365_out")
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=500,
                    help="dump partial results every N images")
    add_model_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    from ..data import DatasetCatalog, build_detection_test_loader
    from ..data.datasets.objects365 import register_objects365
    from ..evaluation import COCOEvaluator

    args = parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    if DATASET in DatasetCatalog:
        DatasetCatalog.remove(DATASET)
    register_objects365(DATASET, args.gt_json, args.image_root)
    model = build_and_load(cfg, args.weights, args.device)
    dev = model.pixel_mean.device

    os.makedirs(args.out_dir, exist_ok=True)
    evaluator = COCOEvaluator(DATASET, output_dir=args.out_dir)
    evaluator.reset()
    loader = build_detection_test_loader(cfg, DATASET, batch_size=args.batch_size,
                                         mapper=PNGReadingMapper(cfg, is_train=False))
    seen = chunk_id = 0
    for batch in loader:
        inputs = {k: torch.as_tensor(np.asarray(batch[k]), device=dev)
                  for k in INPUT_KEYS if k in batch}
        evaluator.process(batch, to_numpy(model.predict(inputs)))
        seen += int(np.sum(batch.get("batch_valid", [True] * len(batch["image_id"]))))
        if seen and seen % args.chunk == 0:
            dump_partial(evaluator, args.out_dir, chunk_id)
            chunk_id += 1
        if args.max_images and seen >= args.max_images:
            break
    results = evaluator.evaluate()
    with open(os.path.join(args.out_dir, "obj365_metrics.json"), "w") as f:
        json.dump(results, f, default=float)
    print(json.dumps({k: dict(v) for k, v in results.items()}, default=float)[:2000])
    return results


def dump_partial(evaluator, out_dir: str, chunk_id: int) -> None:
    insts = [i for p in evaluator._predictions for i in p["instances"]]
    with open(os.path.join(out_dir, f"results_chunk_{chunk_id:04d}.json"), "w") as f:
        json.dump(insts, f)
    print(f"dumped chunk {chunk_id} ({len(insts)} dets)")


if __name__ == "__main__":
    main()
