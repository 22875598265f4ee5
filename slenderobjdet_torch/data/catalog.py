"""Dataset + metadata catalogs (counterpart of detectron2's DatasetCatalog /
MetadataCatalog used throughout the reference's data layer,
`slender_det/data/datasets/builtin.py`).

The port's own registries: a copy of ``slenderobjdet_tpu/data/catalog.py``
that shares nothing with the registries there."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry:
            raise KeyError(f"dataset {name!r} already registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(
                f"dataset {name!r} not registered. Available: "
                f"{sorted(self._registry)}"
            )
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)

    def __contains__(self, name):
        return name in self._registry


class Metadata:
    """Attribute bag for per-dataset metadata (thing_classes, id maps, ...)."""

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            object.__setattr__(self, k, v)
        return self

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._map: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._map:
            self._map[name] = Metadata(name)
        return self._map[name]

    def list(self):
        return sorted(self._map)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
