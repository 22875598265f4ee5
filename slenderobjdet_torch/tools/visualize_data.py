"""Draw dataset annotations or loader outputs and count the annotations'
slenderness ratios (counterpart of ``tools/visualize_data.py``: the same
flags). ``--source annotation`` draws the raw dataset dicts' boxes and counts
empty and problematic segmentations; ``--source dataloader`` draws the
mapper's padded gt as the model sees it. Images are written as PNG.

    python -m slenderobjdet_torch.tools.visualize_data --source annotation \\
        --config-file cfg.yaml --gt-json inst.json --image-root images/ \\
        [--output-dir vis_data] [--max-images 20] [--serve]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.visualizer import Visualizer
from ._common import PNGReadingMapper, load_cfg, read_bgr, write_png

DATASET = "_visualize_data"


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    from ..data import DatasetCatalog, build_detection_train_loader
    from ..data.datasets import register_coco_instances
    from ..structures.masks import compute_ann_ratio

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=["annotation", "dataloader"], required=True)
    ap.add_argument("--config-file", default="")
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--output-dir", default="vis_data")
    ap.add_argument("--max-images", type=int, default=20)
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args(argv)
    if DATASET in DatasetCatalog:
        DatasetCatalog.remove(DATASET)
    register_coco_instances(DATASET, args.gt_json, args.image_root)
    written: List[str] = []

    def output(img, fname):
        if args.serve:
            from ..utils import webcv2

            webcv2.imshow(fname, img)
        written.append(write_png(os.path.join(args.output_dir, fname), img))

    if args.source == "dataloader":
        cfg = load_cfg(args.config_file, ["DATASETS.TRAIN", (DATASET,)])
        for batch in build_detection_train_loader(cfg, mapper=PNGReadingMapper(cfg, True)):
            for i in range(len(batch["image"])):
                valid = np.asarray(batch["gt_valid"][i])
                vis = Visualizer(np.asarray(batch["image"][i]).astype(np.uint8).copy())
                vis.draw_boxes(np.asarray(batch["gt_boxes"][i])[valid],
                               classes=np.asarray(batch["gt_classes"][i])[valid])
                output(vis.get(), f"{int(batch['image_id'][i])}.png")
                if len(written) >= args.max_images:
                    print(f"wrote {len(written)} loader views to {args.output_dir}")
                    return {"written": len(written)}
        return {"written": len(written)}

    counts = {"all": 0, "empty": 0, "problematic": 0}
    for dic in DatasetCatalog.get(DATASET):
        for obj in dic.get("annotations", []):
            counts["all"] += 1
            if not obj.get("segmentation"):
                counts["empty"] += 1
                continue
            try:
                compute_ann_ratio(obj)
            except Exception:
                counts["problematic"] += 1
        if len(written) < args.max_images:
            img = read_bgr(dic["file_name"])
            if img is not None:
                boxes = np.array([o["bbox"] for o in dic.get("annotations", [])],
                                 np.float32).reshape(-1, 4)
                boxes[:, 2:] += boxes[:, :2]
                output(Visualizer(img).draw_boxes(boxes), os.path.basename(dic["file_name"]))
    for k, v in counts.items():
        print(k, v)
    return {**counts, "written": len(written)}


if __name__ == "__main__":
    main()
