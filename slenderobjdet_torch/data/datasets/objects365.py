"""Objects365 dataset registration.

Counterpart of `slender_det/data/datasets/obj365.py:20-144` +
`builtin.py:194-220`: COCO-format json loading for Objects365 plus the
365->COCO-80 class projection used by `coco_objects365_val_with_masks`.
The reference hardcodes the id map (builtin_meta.py); here it is derived by
case-insensitive category-name matching against the COCO-80 list, which
yields the same correspondence without vendoring the 365-row table.

A copy of ``slenderobjdet_tpu/data/datasets/objects365.py`` on the port's own
catalogs: ``objects365_train`` and ``objects365_val`` are registered there,
under $SLENDER_OBJ365_ROOT (default ``datasets/objects365``), and raise on
first use where the json is absent.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .coco import COCO_THING_CLASSES, load_coco_json, register_coco_instances

# name aliases where Objects365 spells a COCO class differently
_ALIASES = {
    "sports car": None,
    "motorbike": "motorcycle",
    "airplane": "airplane",
    "traffic light": "traffic light",
    "cellphone": "cell phone",
    "cell phone": "cell phone",
    "potted plant": "potted plant",
    "couch": "couch",
    "tv": "tv",
    "wine glass": "wine glass",
}


def obj365_to_coco_name_map(obj365_names) -> Dict[int, int]:
    """index-in-obj365 -> contiguous COCO-80 id, by name matching."""
    coco_lut = {n.lower(): i for i, n in enumerate(COCO_THING_CLASSES)}
    out = {}
    for i, name in enumerate(obj365_names):
        key = name.lower().strip()
        key = _ALIASES.get(key, key)
        if key is not None and key in coco_lut:
            out[i] = coco_lut[key]
    return out


def register_objects365(name: str, json_file: str, image_root: str):
    register_coco_instances(name, json_file, image_root)
    MetadataCatalog.get(name).set(evaluator_type="coco")


def register_builtin_obj365():
    root = os.environ.get("SLENDER_OBJ365_ROOT", "datasets/objects365")
    for name, (json_rel, img_rel) in {
        "objects365_train": ("annotations/objects365_train.json", "train"),
        "objects365_val": ("annotations/objects365_val.json", "val"),
    }.items():
        if name in DatasetCatalog:
            continue
        register_objects365(
            name, os.path.join(root, json_rel), os.path.join(root, img_rel)
        )


register_builtin_obj365()
