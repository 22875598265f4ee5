"""Draw the anchor grid over sample images, or each saved proposal with its
source anchor (counterpart of ``tools/visualize_anchors.py``: the same
flags). Writes ``anchors_<i>.png``.

    python -m slenderobjdet_torch.tools.visualize_anchors --config-file configs/retina/... \\
        --out-dir vis_anchors [--num-images 4] [--per-level 20] \\
        [--proposals-pkl box_proposals.pkl]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np

from ..models.anchors import AnchorGeneratorSpec
from ..utils.visualizer import Visualizer
from ._common import PNGReadingMapper, load_cfg, write_png


def main(argv: Optional[List[str]] = None) -> List[str]:
    from ..data import build_detection_test_loader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out-dir", default="vis_anchors")
    ap.add_argument("--num-images", type=int, default=4)
    ap.add_argument("--per-level", type=int, default=20)
    ap.add_argument("--proposals-pkl", default="",
                    help="box_proposals.pkl: draw each proposal with its source anchor "
                         "instead of the raw grid")
    args = ap.parse_args(argv)
    cfg = load_cfg(args.config_file)
    feats = (cfg.MODEL.RETINANET.IN_FEATURES if "RetinaNet" in cfg.MODEL.META_ARCHITECTURE
             else cfg.MODEL.RPN.IN_FEATURES)
    spec = AnchorGeneratorSpec(cfg, [2 ** int(f[1:]) for f in feats])
    loader = build_detection_test_loader(cfg, cfg.DATASETS.TEST[0], batch_size=1,
                                         mapper=PNGReadingMapper(cfg, is_train=False))
    saved = {}
    if args.proposals_pkl:
        with open(args.proposals_pkl, "rb") as f:
            data = pickle.load(f)
        saved = {i: (bx, an) for i, bx, an in zip(data["ids"], data["boxes"], data["anchors"])}
    rng = np.random.default_rng(0)
    written = []
    for i, batch in enumerate(loader):
        if i >= args.num_images:
            continue
        img = np.asarray(batch["image"][0]).astype(np.uint8).copy()
        vis = Visualizer(img)
        if saved:
            img_id = int(batch["image_id"][0])
            if img_id not in saved:
                continue
            bx, an = saved[img_id]
            n = min(args.per_level, len(bx))
            scale = float(batch["scale"][0])           # the pkl is in original coordinates
            vis.draw_proposals(np.asarray(bx[:n]) * scale)
            if an is not None:
                vis.draw_anchors(np.asarray(an[:n]) * scale)
        else:
            anchors, counts = spec.anchors(img.shape[:2])
            off = 0
            for c in counts:
                pick = rng.choice(c, min(args.per_level, c), replace=False) + off
                vis.draw_proposals(anchors[pick], max_n=args.per_level)
                off += c
        written.append(write_png(os.path.join(args.out_dir, f"anchors_{i}.png"), vis.get()))
    print("wrote", args.out_dir)
    return written


if __name__ == "__main__":
    main()
