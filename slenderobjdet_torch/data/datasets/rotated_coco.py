"""Rotated-COCO dataset registration (counterpart of
``slenderobjdet_tpu/data/datasets/rotated_coco.py``; the reference's rcoco
registration, ``slender_det/data/datasets/builtin.py:221-259``).

A COCO-format json whose annotations each gain an XYWHA ``rbox``: the one
stored in the json, else the oriented minimum-area rectangle of its
segmentation polygons (``structures/masks.py:rbox_from_polygon``, angle in
(-45, 45] with w and h swapped to match; no cv2), else its axis-aligned box
at angle 0. The datasets' evaluator_type is "rcoco"
(``evaluation/rotated_evaluation.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ...structures.masks import rbox_from_polygon
from ..catalog import DatasetCatalog, MetadataCatalog
from .coco import load_coco_json


def load_rotated_coco_json(json_file: str, image_root: str,
                           dataset_name: Optional[str] = None) -> List[dict]:
    dataset_dicts = load_coco_json(json_file, image_root, dataset_name)
    for record in dataset_dicts:
        for obj in record["annotations"]:
            if "rbox" in obj:
                continue
            segm = obj.get("segmentation")
            polys = ([p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                     if isinstance(segm, list) else [])
            if polys:
                obj["rbox"] = rbox_from_polygon(polys)
            else:
                x1, y1, x2, y2 = obj["bbox"]
                obj["rbox"] = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, 0.0]
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(evaluator_type="rcoco")
    return dataset_dicts


def register_rotated_coco_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(
        name, lambda: load_rotated_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="rcoco")


def register_builtin_rotated():
    root = os.environ.get("SLENDER_COCO_ROOT", "datasets/coco")
    for name, (json_rel, img_rel) in {
        "rcoco_2017_train": ("annotations/instances_train2017.json", "train2017"),
        "rcoco_2017_val": ("annotations/instances_val2017.json", "val2017"),
    }.items():
        if name in DatasetCatalog:
            continue
        register_rotated_coco_instances(
            name, os.path.join(root, json_rel), os.path.join(root, img_rel))


register_builtin_rotated()
