from .coco import load_coco_json, register_builtin, register_coco_instances
from .objects365 import (obj365_to_coco_name_map, register_builtin_obj365,
                         register_objects365)
from .rotated_coco import (load_rotated_coco_json, register_builtin_rotated,
                           register_rotated_coco_instances)

__all__ = [
    "load_coco_json",
    "register_builtin",
    "register_coco_instances",
    "obj365_to_coco_name_map",
    "register_builtin_obj365",
    "register_objects365",
    "load_rotated_coco_json",
    "register_builtin_rotated",
    "register_rotated_coco_instances",
]
