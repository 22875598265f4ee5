from .coco import load_coco_json, register_builtin, register_coco_instances

__all__ = [
    "load_coco_json",
    "register_builtin",
    "register_coco_instances",
]
