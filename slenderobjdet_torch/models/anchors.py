"""FCOS location grids and anchor generation (host-side numpy; the port's
own copy of ``slenderobjdet_tpu/models/anchors.py``, held equal to it bit for
bit by ``tests/test_torch_retinanet.py``). Anchors follow detectron2's
DefaultAnchorGenerator: per-level sizes x aspect ratios, a cell's anchors
centred at 0 and shifted by ``(arange + OFFSET) * stride``. The rotated
generator comes with the rotated detectors."""

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


def generate_cell_anchors(
    sizes: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """(num_sizes*num_ratios, 4) XYXY anchors centred at (0, 0), size-major."""
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.array(anchors, dtype=np.float32)


def anchors_per_level(
    h: int, w: int, stride: int, cell_anchors: np.ndarray, offset: float = 0.0
) -> np.ndarray:
    """(h*w*A, 4) anchors for one level (XYXY, absolute coordinates), cell by
    cell in row-major order and, within a cell, in ``cell_anchors`` order."""
    shift_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shift_y = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.reshape(-1), sy.reshape(-1)] * 2, axis=1)  # (hw, 4) x,y,x,y
    return (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4)


class AnchorGeneratorSpec:
    """Static anchor metadata built from cfg.MODEL.ANCHOR_GENERATOR: SIZES and
    ASPECT_RATIOS broadcast over the levels, OFFSET."""

    def __init__(self, cfg, strides: Sequence[int]):
        sizes = cfg.MODEL.ANCHOR_GENERATOR.SIZES
        ratios = cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS
        num_levels = len(strides)
        if len(sizes) == 1:
            sizes = list(sizes) * num_levels
        if len(ratios) == 1:
            ratios = list(ratios) * num_levels
        assert len(sizes) == num_levels and len(ratios) == num_levels
        self.strides = list(strides)
        self.offset = cfg.MODEL.ANCHOR_GENERATOR.OFFSET
        self.cell_anchors = [
            generate_cell_anchors(s, r) for s, r in zip(sizes, ratios)
        ]
        self.num_cell_anchors = [a.shape[0] for a in self.cell_anchors]

    def anchors(self, image_hw: Tuple[int, int]) -> Tuple[np.ndarray, List[int]]:
        """((sum hwA, 4), [count per level]) for a fixed padded image size."""
        shapes = feature_map_shapes(image_hw, self.strides)
        per_level = [
            anchors_per_level(h, w, s, ca, self.offset)
            for (h, w), s, ca in zip(shapes, self.strides, self.cell_anchors)
        ]
        counts = [a.shape[0] for a in per_level]
        return np.concatenate(per_level, axis=0), counts
