"""Test-time augmentation, multi-scale and horizontal flip (counterpart of
``slenderobjdet_tpu/engine/tta.py``, after detectron2's
GeneralizedRCNNWithTTA as the reference's eval path wires it, cfg.TEST.AUG.*):
each image runs at every ``TEST.AUG.MIN_SIZES`` short side (with
``TEST.AUG.MAX_SIZE``), flipped too with ``TEST.AUG.FLIP``; the detections
are mapped back to original coordinates and merged by a class-aware NMS on
the host (numpy: at most 100 boxes a view).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.mapper import DatasetMapper


def _nms_numpy(boxes, scores, classes, thresh, max_out):
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    shifted = boxes + classes[:, None].astype(np.float64) * 1e5
    areas = (shifted[:, 2] - shifted[:, 0]).clip(0) * \
        (shifted[:, 3] - shifted[:, 1]).clip(0)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= max_out:
            break
        ix1 = np.maximum(shifted[i, 0], shifted[:, 0])
        iy1 = np.maximum(shifted[i, 1], shifted[:, 1])
        ix2 = np.minimum(shifted[i, 2], shifted[:, 2])
        iy2 = np.minimum(shifted[i, 3], shifted[:, 3])
        inter = (ix2 - ix1).clip(0) * (iy2 - iy1).clip(0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-12)
        suppressed |= iou > thresh
    return keep


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def tta_predict(
    model,
    dataset_dict: Dict,
    cfg,
    predict_fns: Optional[Dict[tuple, Callable]] = None,
) -> Dict[str, np.ndarray]:
    """Run one image through all TTA views; returns the merged detections
    (boxes, scores, classes) in original coordinates. ``predict_fns`` holds
    one predict a view key (short side, padded shape, flip): ``model.predict``
    where a key is missing (a caller may put, say, a loaded serving artifact
    of that bucket there)."""
    min_sizes = list(cfg.TEST.AUG.MIN_SIZES)
    do_flip = cfg.TEST.AUG.FLIP
    dev = next(model.parameters()).device
    all_boxes, all_scores, all_classes = [], [], []

    for short in min_sizes:
        view_cfg = cfg.clone()
        view_cfg.defrost()
        view_cfg.INPUT.MIN_SIZE_TEST = short
        view_cfg.INPUT.MAX_SIZE_TEST = cfg.TEST.AUG.MAX_SIZE
        mapper = DatasetMapper(view_cfg, is_train=False)
        for flip in ([False, True] if do_flip else [False]):
            ex = mapper(dict(dataset_dict))
            img = ex["image"]
            if flip:
                # flip only the VALID resized region, not the padded canvas:
                # content stays at x in [0, rw], so predict's clip to the
                # original extent holds and un-mirroring is a reflection
                rw = int(ex["image_size"][1])
                img = img.copy()
                img[:, :rw] = img[:, :rw][:, ::-1]
                img = np.ascontiguousarray(img)
            batch = {
                "image": torch.as_tensor(img[None], device=dev),
                "scale": torch.tensor([ex["scale"]], dtype=torch.float32, device=dev),
                "orig_size": torch.as_tensor(ex["orig_size"][None], device=dev),
                "image_size": torch.as_tensor(ex["image_size"][None], device=dev),
            }
            key = (short, img.shape[:2], flip)
            if predict_fns is not None and key in predict_fns:
                pf = predict_fns[key]
            else:
                pf = model.predict
                if predict_fns is not None:
                    predict_fns[key] = pf
            out = pf(batch)
            valid = _host(out["valid"][0])
            boxes = _host(out["boxes"][0])[valid]
            scores = _host(out["scores"][0])[valid]
            classes = _host(out["classes"][0])[valid]
            if flip and len(boxes):
                orig_w = float(ex["orig_size"][1])
                # the reflection axis: the valid resized width mapped back to
                # original coordinates (within a pixel of orig_w)
                mirror_w = float(ex["image_size"][1]) / float(ex["scale"])
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = mirror_w - boxes[:, 2]
                boxes[:, 2] = mirror_w - x1
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, orig_w)
            all_boxes.append(boxes)
            all_scores.append(scores)
            all_classes.append(classes)

    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
    scores = np.concatenate(all_scores) if all_scores else np.zeros((0,))
    classes = np.concatenate(all_classes) if all_classes else np.zeros((0,), np.int32)
    keep = _nms_numpy(boxes, scores, classes,
                      cfg.MODEL.RETINANET.NMS_THRESH_TEST,
                      cfg.TEST.DETECTIONS_PER_IMAGE)
    return {"boxes": boxes[keep], "scores": scores[keep], "classes": classes[keep]}
