"""FCOS location grids and anchor generation (host-side numpy; the port's
own copy of ``slenderobjdet_tpu/models/anchors.py``, held equal to it bit for
bit by ``tests/test_torch_retinanet.py``). Anchors follow detectron2's
DefaultAnchorGenerator: per-level sizes x aspect ratios, a cell's anchors
centred at 0 and shifted by ``(arange + OFFSET) * stride``; the rotated
generator (``RotatedAnchorGeneratorSpec``, detectron2's
RotatedAnchorGenerator) gives XYWHA anchors of SIZES x ASPECT_RATIOS x
ANGLES a cell."""

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


def rotated_cell_anchors(
    sizes: Sequence[float], aspect_ratios: Sequence[float],
    angles: Sequence[float],
) -> np.ndarray:
    """(S*R*A, 5) XYWHA cell anchors centred at the origin: size-major, then
    ratio, then angle."""
    out = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            for a in angles:
                out.append([0.0, 0.0, w, h, a])
    return np.array(out, np.float32)


class RotatedAnchorGeneratorSpec:
    """SIZES, ASPECT_RATIOS and ANGLES broadcast over the levels, anchors at
    ``(grid + OFFSET) * stride`` in XYWHA; shared by the rotated RetinaNet
    and the RRPN."""

    def __init__(self, cfg, strides: Sequence[int]):
        g = cfg.MODEL.ANCHOR_GENERATOR
        sizes, ratios, angles = g.SIZES, g.ASPECT_RATIOS, g.ANGLES
        n = len(strides)
        sizes = list(sizes) * n if len(sizes) == 1 else sizes
        ratios = list(ratios) * n if len(ratios) == 1 else ratios
        angles = list(angles) * n if len(angles) == 1 else angles
        self.strides = list(strides)
        self.offset = g.OFFSET
        self.cell_anchors = [
            rotated_cell_anchors(s, r, a)
            for s, r, a in zip(sizes, ratios, angles)
        ]
        self.num_cell_anchors = [c.shape[0] for c in self.cell_anchors]

    def anchors(self, image_hw) -> Tuple[np.ndarray, List[int]]:
        """((sum hwA, 5), [count per level]) for a padded image size, cell
        by cell in row-major order, a cell's anchors in cell order."""
        shapes = feature_map_shapes(image_hw, self.strides)
        per_level = []
        for (h, w), s, ca in zip(shapes, self.strides, self.cell_anchors):
            sx = (np.arange(w, dtype=np.float32) + self.offset) * s
            sy = (np.arange(h, dtype=np.float32) + self.offset) * s
            gx, gy = np.meshgrid(sx, sy)
            shifts = np.stack(
                [gx.reshape(-1), gy.reshape(-1)]
                + [np.zeros(h * w, np.float32)] * 3,
                axis=1,
            )
            per_level.append(
                (shifts[:, None, :] + ca[None, :, :]).reshape(-1, 5)
            )
        counts = [a.shape[0] for a in per_level]
        return np.concatenate(per_level), counts


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
