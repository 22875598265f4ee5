from .build import (
    build_detection_test_loader,
    build_detection_train_loader,
    get_detection_dataset_dicts,
)
from .catalog import DatasetCatalog, MetadataCatalog
from .mapper import DatasetMapper
from . import datasets  # noqa: F401  (registers builtins)

__all__ = [
    "build_detection_test_loader",
    "build_detection_train_loader",
    "get_detection_dataset_dicts",
    "DatasetCatalog",
    "MetadataCatalog",
    "DatasetMapper",
]
