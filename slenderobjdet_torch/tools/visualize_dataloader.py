"""Draw the ground truth as the training loader hands it to the model
(counterpart of ``tools/visualize_dataloader.py``: the same flags). Writes
``b<batch>_i<index>_id<image id>.png``; ``--serve`` also shows them on
``utils/webcv2.py``'s gallery at :8888.

    python -m slenderobjdet_torch.tools.visualize_dataloader --config-file configs/fcos/... \\
        --out-dir vis_gt [--num-batches 2] [--serve]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..utils.visualizer import Visualizer
from ._common import PNGReadingMapper, load_cfg, write_png


def main(argv: Optional[List[str]] = None) -> List[str]:
    from ..data import build_detection_train_loader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out-dir", default="vis_gt")
    ap.add_argument("--num-batches", type=int, default=2)
    ap.add_argument("--serve", action="store_true", help="also serve via webcv2 on :8888")
    args = ap.parse_args(argv)
    cfg = load_cfg(args.config_file)
    it = iter(build_detection_train_loader(cfg, mapper=PNGReadingMapper(cfg, is_train=True)))
    written = []
    for b in range(args.num_batches):
        batch = next(it)
        for i in range(batch["image"].shape[0]):
            img = np.asarray(batch["image"][i]).astype(np.uint8).copy()
            n = int(batch["gt_valid"][i].sum())
            out = Visualizer(img).draw_boxes(batch["gt_boxes"][i][:n],
                                             classes=batch["gt_classes"][i][:n])
            name = f"b{b}_i{i}_id{batch['image_id'][i]}"
            written.append(write_png(os.path.join(args.out_dir, name + ".png"), out))
            if args.serve:
                from ..utils import webcv2

                webcv2.imshow(name, out)
    print("wrote", args.out_dir)
    if args.serve:
        input("serving on :8888, press enter to exit")
    return written


if __name__ == "__main__":
    main()
