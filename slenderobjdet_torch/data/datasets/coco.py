"""COCO-format dataset loading + builtin registration.

Counterpart of `slender_det/data/datasets/builtin.py` + detectron2's
load_coco_json: parses a COCO instances json into detectron2-style dataset
dicts (file_name, height, width, image_id, annotations[{bbox XYXY_ABS,
category_id contiguous, iscrowd, segmentation, ratio}]).

The COCO root is discovered from $SLENDER_COCO_ROOT or ./datasets/coco; if
absent, the builtin names stay registered and raise a clear error on first
use (tests register synthetic datasets through the same API).

A copy of ``slenderobjdet_tpu/data/datasets/coco.py`` on the port's own
catalogs. The rotated-box views of the builtin jsons (``rotated_coco.py``)
and Objects365 are not ported yet: they come with the rotated detectors and
the other FCOS-family detectors, and their names are not registered here.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ...evaluation.coco_api import COCO
from ..catalog import DatasetCatalog, MetadataCatalog

COCO_THING_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def load_coco_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
) -> List[dict]:
    coco_api = COCO(json_file)

    cat_ids = sorted(coco_api.getCatIds())
    id_map = {v: i for i, v in enumerate(cat_ids)}
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        cats = coco_api.loadCats(cat_ids)
        meta.set(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
            json_file=json_file,
            image_root=image_root,
        )

    img_ids = sorted(coco_api.imgs.keys())
    dataset_dicts = []
    for img_id in img_ids:
        img = coco_api.imgs[img_id]
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
        }
        objs = []
        for ann in coco_api.imgToAnns.get(img_id, []):
            x, y, w, h = ann["bbox"]
            obj = {
                "bbox": [x, y, x + w, y + h],  # XYXY_ABS
                "category_id": id_map[ann["category_id"]],
                "iscrowd": ann.get("iscrowd", 0),
                "ratio": ann.get("ratio", 1.0),
            }
            if "segmentation" in ann:
                obj["segmentation"] = ann["segmentation"]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts


def register_coco_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco"
    )


def _coco_root() -> Optional[str]:
    root = os.environ.get("SLENDER_COCO_ROOT", "datasets/coco")
    return root if os.path.isdir(root) else None


_BUILTIN = {
    "coco_2017_train": ("annotations/instances_train2017.json", "train2017"),
    "coco_2017_val": ("annotations/instances_val2017.json", "val2017"),
}


def register_builtin():
    root = os.environ.get("SLENDER_COCO_ROOT", "datasets/coco")
    for name, (json_rel, img_rel) in _BUILTIN.items():
        if name in DatasetCatalog:
            continue
        register_coco_instances(
            name, os.path.join(root, json_rel), os.path.join(root, img_rel)
        )


register_builtin()
