"""FCOS location grids (host-side numpy; copied from
``slenderobjdet_tpu/models/anchors.py``, whose package imports flax)."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def feature_map_shapes(
    image_hw: Tuple[int, int], strides: Sequence[int]
) -> List[Tuple[int, int]]:
    """Feature map (h, w) per stride: ceil(size / stride)."""
    h, w = image_hw
    return [(int(math.ceil(h / s)), int(math.ceil(w / s))) for s in strides]


def locations_per_level(h: int, w: int, stride: int) -> np.ndarray:
    """(h*w, 2) array of (x, y) location coordinates, FCOS convention."""
    xs = np.arange(w, dtype=np.float32) * stride + stride // 2
    ys = np.arange(h, dtype=np.float32) * stride + stride // 2
    xg, yg = np.meshgrid(xs, ys)  # row-major: y outer, x inner
    return np.stack([xg.reshape(-1), yg.reshape(-1)], axis=1)


def fcos_locations(
    image_hw: Tuple[int, int], strides: Sequence[int]
) -> Tuple[np.ndarray, List[int]]:
    """All-level locations concatenated: ((sum hw, 2), [count per level])."""
    shapes = feature_map_shapes(image_hw, strides)
    locs = [locations_per_level(h, w, s) for (h, w), s in zip(shapes, strides)]
    counts = [l.shape[0] for l in locs]
    return np.concatenate(locs, axis=0), counts
