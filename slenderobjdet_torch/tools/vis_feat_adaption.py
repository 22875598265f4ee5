"""Draw the feature-adaption sampling points of a RepPoints-family detector
(counterpart of ``tools/vis_feat_adaption.py``: the same flags): for each of
the top-scoring locations of an image, its centre and the P initial points
that drive the deformable conv, each joined to the centre.

    python -m slenderobjdet_torch.tools.vis_feat_adaption \\
        --config-file configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml \\
        --gt-json inst.json --image-root images/ [--out-dir vis_adapt] \\
        [--weights model.pth] [--num-images 4] [--top-locations 30] [--device cpu]

Writes ``adaption_<image id>.png`` (PNG, by ``utils/png.py``: the card's
machine has no image codec; the JAX tool writes JPEG with cv2), drawn by
``utils/draw.py``. Without ``--device`` the model runs on the card.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from ..utils import draw
from ._common import PNGReadingMapper, add_model_args, build_and_load, load_cfg, write_png

DATASET = "_vis_feat_adaption"
CENTER_COLOR, POINT_COLOR, LINK_COLOR = (0, 0, 255), (0, 255, 255), (120, 120, 120)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--out-dir", default="vis_adapt")
    ap.add_argument("--num-images", type=int, default=4)
    ap.add_argument("--top-locations", type=int, default=30)
    add_model_args(ap)
    return ap.parse_args(argv)


def top_point_sets(model, logits_l, init_l, image_hw, top: int):
    """[(centre (2,), points (P, 2)), ...] of the ``top`` locations by their
    best class score, image 0, in the JAX tool's order."""
    centers, counts, _ = model._centers(image_hw)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    scores = np.concatenate([torch.sigmoid(x.float()).amax(-1)[0].cpu().numpy()
                             for x in logits_l])
    sets = []
    for loc in np.argsort(-scores)[:top]:
        lvl = int(np.searchsorted(offsets, loc, side="right")) - 1
        deltas = init_l[lvl][0, loc - offsets[lvl]].float().cpu().numpy().reshape(
            model.num_points, 2)
        c = centers[loc]
        sets.append((c, deltas * model.point_strides[lvl] + c))
    return sets


def draw_point_sets(img: np.ndarray, sets) -> np.ndarray:
    """The JAX tool's drawing, in its order, in place."""
    for c, pts in sets:
        draw.circle_filled(img, (int(c[0]), int(c[1])), 3, CENTER_COLOR)
        for p in pts:
            draw.circle_filled(img, (int(p[0]), int(p[1])), 1, POINT_COLOR)
            draw.line(img, (int(c[0]), int(c[1])), (int(p[0]), int(p[1])), LINK_COLOR)
    return img


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> List[str]:
    from ..data import DatasetCatalog, build_detection_test_loader
    from ..data.datasets import register_coco_instances

    args = parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    model = build_and_load(cfg, args.weights, args.device)
    if not hasattr(model, "_centers"):
        raise SystemExit("feat-adaption visualization needs a RepPoints-family model "
                         f"(got {cfg.MODEL.META_ARCHITECTURE})")
    if DATASET in DatasetCatalog:
        DatasetCatalog.remove(DATASET)
    register_coco_instances(DATASET, args.gt_json, args.image_root)
    loader = build_detection_test_loader(cfg, DATASET, batch_size=1,
                                         mapper=PNGReadingMapper(cfg, is_train=False))
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for batch in loader:
        if len(written) >= args.num_images:
            break
        images = torch.as_tensor(np.asarray(batch["image"]), device=model.pixel_mean.device)
        outs = model(images)
        sets = top_point_sets(model, outs[0], outs[1], tuple(images.shape[1:3]),
                              args.top_locations)
        img = np.asarray(batch["image"][0]).astype(np.uint8).copy()
        written.append(write_png(os.path.join(
            args.out_dir, f"adaption_{int(batch['image_id'][0])}.png"), draw_point_sets(img, sets)))
    print(f"wrote {len(written)} feature-adaption views to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
