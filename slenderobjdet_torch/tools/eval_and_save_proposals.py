"""Run a two-stage model or a proposal network over a dataset and save its
RPN proposals with their source anchors (counterpart of
``tools/eval_and_save_proposals.py``: the same flags and the same ``.pkl``
schema, ``boxes``, ``anchors``, ``objectness_logits``, ``ids``,
``bbox_mode``), the input of the proposal and AR-by-ratio study.

    python -m slenderobjdet_torch.tools.eval_and_save_proposals \\
        --config-file configs/faster/faster_rcnn_R_50_FPN_1x.yaml \\
        [--weights model.pth] [--out box_proposals.pkl] [--max-images 100] \\
        [--device cpu] [KEY VALUE ...]

The test set is the config's first ``DATASETS.TEST``; PNG images are decoded
without cv2. ``anchors`` holds each image's ``proposal_anchors`` where the
model gives them (``ProposalVisibleRCNNWithAnchor``), else None. Without
``--device`` the model runs on the card: Faster R-CNN R-50-FPN with its
fused flags launches 1 stem, 13 bottleneck and 2 NMS kernels a batch.
"""

from __future__ import annotations

import argparse
import pickle
from typing import List, Optional

import numpy as np
import torch

from ._common import PNGReadingMapper, add_model_args, build_and_load, load_cfg, to_numpy
from .inference_obj365 import INPUT_KEYS

BATCH = 4


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out", default="box_proposals.pkl")
    ap.add_argument("--max-images", type=int, default=100)
    add_model_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    from ..data import build_detection_test_loader

    args = parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    model = build_and_load(cfg, args.weights, args.device)
    dev = model.pixel_mean.device
    loader = build_detection_test_loader(cfg, cfg.DATASETS.TEST[0], batch_size=BATCH,
                                         mapper=PNGReadingMapper(cfg, is_train=False))
    boxes, anchors, logits, ids = [], [], [], []
    for batch in loader:
        inputs = {k: torch.as_tensor(np.asarray(batch[k]), device=dev)
                  for k in INPUT_KEYS if k in batch}
        out = to_numpy(model.predict(inputs))
        valid = out["proposal_valid"]
        for i, img_id in enumerate(batch["image_id"]):
            if not batch["batch_valid"][i]:
                continue
            ids.append(int(img_id))
            boxes.append(out["proposals"][i][valid[i]])
            logits.append(out["proposal_scores"][i][valid[i]])
            anchors.append(out["proposal_anchors"][i][valid[i]]
                           if "proposal_anchors" in out else None)
        if len(ids) >= args.max_images:
            break
    data = {"boxes": boxes, "anchors": anchors, "objectness_logits": logits, "ids": ids,
            "bbox_mode": "XYXY_ABS"}
    with open(args.out, "wb") as f:
        pickle.dump(data, f)
    print(f"saved {len(ids)} images of proposals to {args.out}")
    return data


if __name__ == "__main__":
    main()
