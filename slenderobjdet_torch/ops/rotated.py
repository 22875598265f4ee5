"""Rotated-box geometry: exact IoU, greedy NMS and the delta transform
(XYWHA), the counterpart of ``slenderobjdet_tpu/ops/rotated.py``.

Boxes are (cx, cy, w, h, angle_deg), the angle counter-clockwise in image
coordinates (y down): detectron2's RotatedBoxes convention.

- ``rotated_to_corners``, ``_clip_polygon``, ``_polygon_area`` and
  ``_pair_intersection_area``: the plain version of the intersection, the
  JAX package's fixed 16-vertex buffers (the polygon of one box clipped by
  the four half-planes of the other's edges, in its corner order, compacted
  by a stable argsort and forward-filled), with the shoelace sum taken
  vertex by vertex so that its rounding is one order everywhere.
- ``plain_pairwise_rotated_iou`` and ``plain_rotated_nms``: the plain
  versions of the IoU matrix and of greedy NMS (``max_out`` argmax steps,
  ties to the lowest index, the ``NEG_INF / 2`` liveness test).
- ``extents_apart`` and ``is_point``: the rules by which the kernels skip
  a pair without clipping it (the plain clip's intersection is then
  exactly +0).
- ``pairwise_rotated_iou`` and ``rotated_nms``: on CPU tensors the plain
  versions; on CUDA tensors the kernels of ``csrc/rotated.cu``
  (``launch_rotated_iou``, ``launch_rotated_nms``; one wrapper call counts
  one launch), which give the plain versions' results bit for bit; both
  through the registered operators ``slenderobjdet::rotated_iou`` and
  ``slenderobjdet::rotated_nms``, which ``torch.export`` records.
- ``get_rotated_deltas`` / ``apply_rotated_deltas``: Box2BoxTransformRotated
  (the angle difference floor-modded into [-180, 180)).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build

NEG_INF = -1e10
SLOTS = 16            # vertices a clipped polygon may hold
PLAIN_CHUNK = 1 << 18  # pairs the plain IoU clips at once


def rotated_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) XYWHA -> (..., 4, 2) corners."""
    cx, cy, w, h, a = boxes.unbind(-1)
    theta = a * (math.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    dx = torch.stack([-w / 2, w / 2, w / 2, -w / 2], dim=-1)
    dy = torch.stack([-h / 2, -h / 2, h / 2, h / 2], dim=-1)
    gx = cx[..., None] + dx * c[..., None] + dy * s[..., None]
    gy = cy[..., None] - dx * s[..., None] + dy * c[..., None]
    return torch.stack([gx, gy], dim=-1)


def _polygon_area(pts: torch.Tensor) -> torch.Tensor:
    """Shoelace over forward-filled (..., SLOTS, 2) rings, summed slot by
    slot in order (the repeated slots add exact zeros)."""
    x, y = pts[..., 0], pts[..., 1]
    terms = x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y
    acc = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        acc = acc + terms[..., k]
    return 0.5 * acc.abs()


def _clip_polygon(pts: torch.Tensor, count: torch.Tensor, e0: torch.Tensor,
                  e1: torch.Tensor):
    """Clip rings (P, SLOTS, 2) of ``count`` (P,) vertices by the half-plane
    left of e0 -> e1 (P, 2). Returns the clipped rings, forward-filled, and
    their counts: per vertex the vertex if inside (d >= 0), then the crossing
    point where the edge to the next vertex changes side, the first SLOTS
    kept."""
    n = pts.shape[-2]
    ex = e1[:, 0] - e0[:, 0]
    ey = e1[:, 1] - e0[:, 1]
    d = (ex[:, None] * (pts[..., 1] - e0[:, 1:2])
         - ey[:, None] * (pts[..., 0] - e0[:, 0:1]))
    idx = torch.arange(n, device=pts.device)
    last = (count - 1)[:, None]
    nxt = torch.where(idx[None] == last, 0, (idx[None] + 1) % n)        # (P, n)
    d_next = torch.gather(d, 1, nxt)
    pts_next = torch.gather(pts, 1, nxt[..., None].expand(-1, -1, 2))
    inside, inside_next = d >= 0, d_next >= 0
    in_ring = idx[None] < count[:, None]
    diff = d - d_next
    t = d / torch.where(diff.abs() < 1e-12, 1e-12, diff)
    inter = pts + t[..., None] * (pts_next - pts)
    out = torch.stack([pts, inter], dim=2).reshape(-1, 2 * n, 2)
    emitted = torch.stack([in_ring & inside, in_ring & (inside != inside_next)],
                          dim=2).reshape(-1, 2 * n)
    order = torch.argsort((~emitted).to(torch.int8), dim=1, stable=True)[:, :n]
    out = torch.gather(out, 1, order[..., None].expand(-1, -1, 2))
    kept = torch.gather(emitted, 1, order)
    fill = torch.where(kept, idx[None], 0).cummax(dim=1).values
    out = torch.gather(out, 1, fill[..., None].expand(-1, -1, 2))
    return out, kept.sum(dim=1)


def _pair_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of the polygons ``c1`` (..., 4, 2) clipped by the
    boxes ``c2`` (..., 4, 2), broadcast over the leading dimensions."""
    shape = torch.broadcast_shapes(c1.shape[:-2], c2.shape[:-2])
    c1 = c1.expand(*shape, 4, 2).reshape(-1, 4, 2)
    c2 = c2.expand(*shape, 4, 2).reshape(-1, 4, 2)
    pts = torch.cat([c1, c1[:, 3:4].expand(-1, SLOTS - 4, 2)], dim=1)
    count = torch.full((pts.shape[0],), 4, dtype=torch.int64, device=pts.device)
    for i in range(4):
        pts, count = _clip_polygon(pts, count, c2[:, i], c2[:, (i + 1) % 4])
    area = torch.where(count >= 3, _polygon_area(pts), 0.0)
    return area.reshape(shape)


def plain_pairwise_rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                               chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """(N, 5), (M, 5) -> (N, M) exact IoU, each row's polygon clipped by
    each column's box; the pairs clipped ``chunk`` at a time."""
    c1, c2 = rotated_to_corners(boxes1), rotated_to_corners(boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    n, m = boxes1.shape[0], boxes2.shape[0]
    if n == 0 or m == 0:
        return boxes1.new_zeros((n, m))
    rows = max(1, chunk // m)
    inter = torch.cat([_pair_intersection_area(c1[s:s + rows, None], c2[None])
                       for s in range(0, n, rows)])
    union = a1[:, None] + a2[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def plain_rotated_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                      max_out: int, valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS over a batch: boxes (B, N, 5), scores (B, N), valid
    (B, N) or None -> keep_idx (B, max_out) int32 (0 where invalid) and
    keep_valid (B, max_out) bool. Each step keeps the argmax live score
    (ties to the lowest index) while it is above NEG_INF / 2 and kills every
    box whose IoU with it (its polygon clipped by the box) exceeds the
    threshold."""
    live = (torch.where(valid, scores, NEG_INF) if valid is not None
            else scores.clone())
    corners = rotated_to_corners(boxes)
    areas = boxes[..., 2] * boxes[..., 3]
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    keep_idx, keep_valid = [], []
    for _ in range(max_out):
        i = torch.argmax(live, dim=1)
        ok = live[rows, i] > NEG_INF / 2
        inter = _pair_intersection_area(corners[rows, i][:, None], corners)
        iou = inter / torch.clamp(areas[rows, i][:, None] + areas - inter, min=1e-12)
        live = torch.where(ok[:, None] & (iou > iou_threshold), NEG_INF, live)
        live[rows, i] = NEG_INF
        keep_idx.append(i)
        keep_valid.append(ok)
    keep_idx = torch.stack(keep_idx, dim=1).to(torch.int32)
    keep_valid = torch.stack(keep_valid, dim=1)
    return torch.where(keep_valid, keep_idx, 0), keep_valid


# ------------------------------------------------ pairs that cannot overlap
MARGIN_SCALE = 2.0 ** -17   # m = MARGIN_SCALE * the pair's largest |coordinate|
SIDE_SCALE = 2.0 ** -16     # a regular box's edges: larger component >= SIDE_SCALE * M


def box_extents(corners: torch.Tensor):
    """(..., 4, 2) corners -> the axis-aligned extent (x0, x1, y0, y1) as
    (..., 4) and the margin scale (...,): the largest |coordinate| where the
    box is regular (finite corners, every edge's larger component at least
    ``SIDE_SCALE`` times it, the first turn counter-clockwise), else +inf."""
    lo, hi = corners.amin(-2), corners.amax(-2)
    box = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    mag = box.abs().amax(-1)
    edges = torch.roll(corners, -1, dims=-2) - corners
    shortest = edges.abs().amax(-1).amin(-1)
    turn = (edges[..., 0, 0] * edges[..., 1, 1]) - (edges[..., 0, 1] * edges[..., 1, 0])
    regular = (torch.isfinite(corners).flatten(-2).all(-1) & (shortest >= SIDE_SCALE * mag)
               & (turn > 0))
    return box, torch.where(regular, mag, torch.full_like(mag, math.inf))


def extents_apart(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Whether boxes ``c1`` and ``c2`` ((..., 4, 2) corners, broadcast)
    cannot overlap: one of the four gaps between their extents exceeds
    ``MARGIN_SCALE`` times the larger of their scales (``box_extents``).
    The plain clip then returns an intersection of exactly +0: the margin
    is derived in ``csrc/rotated.cu``, whose kernels skip such pairs by this
    rule. The plain versions do not call it."""
    (b1, s1), (b2, s2) = box_extents(c1), box_extents(c2)
    margin = MARGIN_SCALE * torch.maximum(s1, s2)
    gap = torch.maximum(torch.maximum(b2[..., 0] - b1[..., 1], b1[..., 0] - b2[..., 1]),
                        torch.maximum(b2[..., 2] - b1[..., 3], b1[..., 2] - b2[..., 3]))
    return gap > margin


def is_point(corners: torch.Tensor) -> torch.Tensor:
    """Whether the four corners (..., 4, 2) are one point (a padded row of
    zeros): clipped by any box, such a polygon has an intersection of
    exactly +0 (its ring holds copies of the point or nothing), so the
    kernels do not clip it either."""
    return (corners == corners[..., :1, :]).all(-1).all(-1)


# ------------------------------------------------------------ the kernels
def _corners_and_areas(boxes: torch.Tensor):
    """The kernels' inputs: (..., 8) float32 corners and (...,) areas,
    formed on the card by ``rotated_corners_kernel``, which repeats the
    plain ``rotated_to_corners`` and ``w * h`` operation for operation."""
    boxes = boxes.to(torch.float32).contiguous()
    corners = torch.empty((*boxes.shape[:-1], 8), dtype=torch.float32, device=boxes.device)
    areas = torch.empty(boxes.shape[:-1], dtype=torch.float32, device=boxes.device)
    rc = _build.library().rotated_corners_launch(
        boxes.data_ptr(), boxes.numel() // 5, corners.data_ptr(), areas.data_ptr(),
        _build.stream_ptr(boxes))
    _build.check(rc, "rotated_corners_launch")
    return corners, areas


def iou_from_corners(c1: torch.Tensor, a1: torch.Tensor, c2: torch.Tensor,
                     a2: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """One launch of the IoU kernel on prepared CUDA inputs: corners (N, 8)
    and (M, 8), areas (N,) and (M,) float32, contiguous, into ``out`` (N, M)."""
    n, m = c1.shape[0], c2.shape[0]
    if n and m:
        rc = _build.library().rotated_iou_launch(
            c1.data_ptr(), a1.data_ptr(), c2.data_ptr(), a2.data_ptr(), n, m,
            out.data_ptr(), _build.stream_ptr(c1))
        _build.check(rc, "rotated_iou_launch")
        _build.LAUNCHES["rotated_iou"] += 1
    return out


def launch_rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """The IoU kernel on CUDA tensors: (N, 5), (M, 5) -> (N, M) float32, the
    corners formed first (two launches of the corner kernel)."""
    _build.require_cuda("rotated_iou", boxes1, boxes2)
    if boxes1.dim() != 2 or boxes2.dim() != 2 or boxes1.shape[1] != 5 \
            or boxes2.shape[1] != 5:
        raise ValueError(f"rotated_iou: boxes {tuple(boxes1.shape)} and "
                         f"{tuple(boxes2.shape)}, expected (N, 5) and (M, 5)")
    out = torch.empty((boxes1.shape[0], boxes2.shape[0]), dtype=torch.float32,
                      device=boxes1.device)
    return iou_from_corners(*_corners_and_areas(boxes1), *_corners_and_areas(boxes2), out)


def nms_kernel_inputs(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                      valid: Optional[torch.Tensor] = None) -> dict:
    """Everything one NMS launch takes, on CUDA tensors: corners, areas,
    scores, valid, the outputs and the scratch (``torch.empty``), after the
    checks ``launch_rotated_nms`` makes."""
    bsz, n = scores.shape
    if boxes.shape != (bsz, n, 5) or n < 1 or max_out < 1 or (
            valid is not None and (valid.shape != (bsz, n) or valid.dtype != torch.bool)):
        raise ValueError(f"rotated_nms: boxes {tuple(boxes.shape)}, scores "
                         f"{tuple(scores.shape)}, max_out {max_out}")
    lib = _build.library()
    if lib.rotated_nms_smem_bytes(n) > torch.cuda.get_device_properties(
            boxes.device).shared_memory_per_block_optin:
        raise ValueError(f"rotated_nms: N={n} candidates do not fit in shared memory "
                         f"(at most 16384 an image)")
    scratch = lib.rotated_nms_scratch_bytes(bsz, n)
    if scratch < 0:
        raise ValueError(f"rotated_nms: B={bsz}, N={n} needs over 2 GiB of scratch")
    corners, areas = _corners_and_areas(boxes)
    dev = boxes.device
    return {"corners": corners, "areas": areas,
            "scores": scores.to(torch.float32).contiguous(),
            "valid": None if valid is None else valid.contiguous(),
            "keep_idx": torch.empty((bsz, max_out), dtype=torch.int32, device=dev),
            "keep_valid": torch.empty((bsz, max_out), dtype=torch.bool, device=dev),
            "scratch": torch.empty(scratch, dtype=torch.uint8, device=dev)}


def nms_from_inputs(inputs: dict, iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wrapper-level launch of the NMS kernels (the sort, then the bits
    and the walk a window) on ``nms_kernel_inputs``' tensors."""
    bsz, max_out = inputs["keep_idx"].shape
    valid = inputs["valid"]
    rc = _build.library().rotated_nms_launch(
        inputs["corners"].data_ptr(), inputs["areas"].data_ptr(), inputs["scores"].data_ptr(),
        None if valid is None else valid.data_ptr(), bsz, inputs["scores"].shape[1],
        ctypes.c_float(iou_threshold), max_out, inputs["keep_idx"].data_ptr(),
        inputs["keep_valid"].data_ptr(), inputs["scratch"].data_ptr(),
        _build.stream_ptr(inputs["scores"]))
    _build.check(rc, "rotated_nms_launch")
    _build.LAUNCHES["rotated_nms"] += 1
    return inputs["keep_idx"], inputs["keep_valid"]


def launch_rotated_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                       max_out: int, valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NMS kernels on CUDA tensors: boxes (B, N, 5), scores (B, N), valid
    (B, N) bool or None -> keep_idx (B, max_out) int32, keep_valid
    (B, max_out) bool, equal to ``plain_rotated_nms``. One corner launch,
    then ``nms_from_inputs``."""
    _build.require_cuda("rotated_nms", *[t for t in (boxes, scores, valid) if t is not None])
    return nms_from_inputs(nms_kernel_inputs(boxes, scores, max_out, valid), iou_threshold)


# The two kernels as registered operators, which ``torch.export`` records as
# one node each: the plain versions on CPU tensors, the kernels on CUDA
# tensors (which raise where the build or a launch fails).
@torch.library.custom_op("slenderobjdet::rotated_iou", mutates_args=(), device_types="cpu",
                         schema="(Tensor boxes1, Tensor boxes2) -> Tensor")
def _iou_plain(boxes1, boxes2):
    return plain_pairwise_rotated_iou(boxes1, boxes2)


@_iou_plain.register_kernel("cuda")
def _iou_kernel(boxes1, boxes2):
    return launch_rotated_iou(boxes1, boxes2)


@_iou_plain.register_fake
def _iou_fake(boxes1, boxes2):
    dtype = torch.float32 if boxes1.device.type == "cuda" else boxes1.dtype
    return boxes1.new_empty((boxes1.shape[0], boxes2.shape[0]), dtype=dtype)


@torch.library.custom_op(
    "slenderobjdet::rotated_nms", mutates_args=(), device_types="cpu",
    schema="(Tensor boxes, Tensor scores, Tensor? valid, float iou_threshold, "
           "int max_out) -> (Tensor, Tensor)")
def _nms_plain(boxes, scores, valid, iou_threshold, max_out):
    return plain_rotated_nms(boxes, scores, iou_threshold, max_out, valid=valid)


@_nms_plain.register_kernel("cuda")
def _nms_kernel(boxes, scores, valid, iou_threshold, max_out):
    return launch_rotated_nms(boxes, scores, iou_threshold, max_out, valid=valid)


@_nms_plain.register_fake
def _nms_fake(boxes, scores, valid, iou_threshold, max_out):
    shape = (scores.shape[0], max_out)
    return (scores.new_empty(shape, dtype=torch.int32),
            scores.new_empty(shape, dtype=torch.bool))


def pairwise_rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5), (M, 5) -> (N, M) exact IoU: the kernel on CUDA tensors, the
    plain version on CPU tensors (the ``slenderobjdet::rotated_iou`` op)."""
    return torch.ops.slenderobjdet.rotated_iou(boxes1, boxes2)


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                max_out: int, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS over a batch (B, N, 5): the kernel on CUDA tensors,
    the plain version on CPU tensors (the ``slenderobjdet::rotated_nms`` op)."""
    return torch.ops.slenderobjdet.rotated_nms(boxes, scores, valid, float(iou_threshold),
                                               int(max_out))


def offset_boxes(boxes: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """Class- or level-aware NMS's shift, as the JAX package forms it: the
    centres moved by float(group) * 4096 in float32 (groups never overlap
    while the image is smaller than 4096 pixels)."""
    off = groups.to(boxes.dtype) * 4096.0
    return torch.cat([boxes[..., :1] + off[..., None], boxes[..., 1:2] + off[..., None],
                      boxes[..., 2:]], dim=-1)


# --------------------------------------------------- rotated delta transform
def get_rotated_deltas(src: torch.Tensor, target: torch.Tensor,
                       weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
                       ) -> torch.Tensor:
    """Box2BoxTransformRotated.get_deltas: the angle difference normalised
    into [-180, 180) and scaled by pi / 180."""
    wx, wy, ww, wh, wa = weights
    eps = 1e-7
    dx = wx * (target[..., 0] - src[..., 0]) / torch.clamp(src[..., 2], min=eps)
    dy = wy * (target[..., 1] - src[..., 1]) / torch.clamp(src[..., 3], min=eps)
    dw = ww * torch.log(torch.clamp(target[..., 2], min=eps)
                        / torch.clamp(src[..., 2], min=eps))
    dh = wh * torch.log(torch.clamp(target[..., 3], min=eps)
                        / torch.clamp(src[..., 3], min=eps))
    da = target[..., 4] - src[..., 4]
    da = torch.remainder(da + 180.0, 360.0) - 180.0
    da = da * (math.pi / 180.0) * wa
    return torch.stack([dx, dy, dw, dh, da], dim=-1)


def apply_rotated_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                         weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
                         ) -> torch.Tensor:
    """Box2BoxTransformRotated.apply_deltas (dw, dh clamped at
    log(1000 / 16)); the angle normalised into [-180, 180)."""
    wx, wy, ww, wh, wa = weights
    clamp = math.log(1000.0 / 16.0)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clamp)
    dh = torch.clamp(deltas[..., 3] / wh, max=clamp)
    da = deltas[..., 4] / wa * (180.0 / math.pi)
    cx = dx * boxes[..., 2] + boxes[..., 0]
    cy = dy * boxes[..., 3] + boxes[..., 1]
    w = torch.exp(dw) * boxes[..., 2]
    h = torch.exp(dh) * boxes[..., 3]
    a = torch.remainder(boxes[..., 4] + da + 180.0, 360.0) - 180.0
    return torch.stack([cx, cy, w, h, a], dim=-1)
