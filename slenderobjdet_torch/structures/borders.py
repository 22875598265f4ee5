"""Border / center / size map rendering from polygons (host-side numpy).

Counterpart of the reference's `BorderMasks`
(`slender_det/structures/borders.py:195-400`): per instance, the convex hull
is dilated by 10% of sqrt(area) and a score map is rendered that is 1 at the
hull center decaying to 0 at the (dilated) border, used by FCOSV3's
mask-based center sampling (fcosv3.py:129-142) and the BorderMaskMapper.

Implementation note: the reference renders per-triangle affine ramps
(cv2 warps) and offsets polygons with pyclipper. For a convex polygon with
interior center O those ramps equal the closed-form radial fraction
t(p) = max_e <n_e, p-O> / <n_e, v_e-O>  (n_e = outward edge normal), so we
compute that directly, vectorized over pixels, with no pyclipper.
score = 1 - t ("linear") or exp(-t^2 / (2 sigma^2)) ("gaussian").

A copy of ``slenderobjdet_tpu/structures/borders.py`` without cv2, which the
card's machine does not have: ``convex_hull`` and ``contour_area`` are numpy
transcriptions of ``cv2.convexHull(points, clockwise=False)`` (Sklansky's
scan over the float32 points sorted by x, then y, then input order; the
same cyclic order, orientation and start vertex, collinear and duplicate
points dropped alike) and ``cv2.contourArea`` (the shoelace sum of float32
vertices accumulated in float64 in cv2's order). The maps depend on all of
them: the fan center is the hull's mean, the closing fan triangle (the last
edge) gets the L2 size, and the area sets the dilation and drops instances
of area <= 1. They run everywhere, with no cv2 branch, and
``tests/test_torch_borders.py`` holds them equal to cv2's and the maps
bit-equal to the JAX package's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import native as _native

# set False to force the pure-numpy renderer (the oracle for the C kernel)
USE_NATIVE = True


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _unit(dx: np.float32, dy: np.float32) -> Tuple[float, float]:
    """cv2's normalisation of a float32 difference vector before the turn
    test: the length and the division in float64, each component rounded
    to float32 (the zero vector stays zero)."""
    x, y = float(dx), float(dy)
    length = math.sqrt(y * y + (x * x + 0.0))
    inv = 1.0 / length if length != 0 else 0.0
    return float(np.float32(x * inv)), float(np.float32(inv * y))


def _sklansky(px: np.ndarray, py: np.ndarray, start: int, end: int,
              nsign: int, sign2: int) -> List[int]:
    """One quarter of the hull between sorted positions ``start`` and
    ``end``: cv2's ``Sklansky_`` for float points (coordinate differences
    in float32, each of the two edge vectors normalised by ``_unit``, the
    turn's sign in float64). Returns the stack, ``start`` first."""
    incr = 1 if end > start else -1
    if start == end or (px[start] == px[end] and py[start] == py[end]):
        return [start]
    pprev, pcur = start, start + incr
    pnext = pcur + incr
    stack = [pprev, pcur, pnext]
    size = 3
    end += incr                                     # one past the end
    while pnext != end:
        cury, nexty = py[pcur], py[pnext]
        by = nexty - cury
        if _sign(by) != nsign:
            ax, ay = _unit(px[pcur] - px[pprev], cury - py[pprev])
            bx, by = _unit(px[pnext] - px[pcur], by)
            convexity = bx * ay - by * ax
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                if size < len(stack):
                    stack[size] = pnext
                else:
                    stack.append(pnext)
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return stack[:size - 1]


def _hull_indices(points: np.ndarray) -> np.ndarray:
    """Indices into ``points`` (N, 2) of the vertices that
    ``cv2.convexHull(points.astype(np.float32), clockwise=False)`` returns,
    in its order. (With ``returnPoints=False`` cv2 may name another of two
    equal points and start elsewhere; the maps use the vertices.)"""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float32)
    total = pts.shape[0]
    if total == 0:
        return np.zeros((0,), np.int64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))      # x, then y, then index
    px, py = pts[order, 0], pts[order, 1]
    miny, maxy = int(np.argmin(py)), int(np.argmax(py))   # first in sort order
    if px[0] == px[-1] and py[0] == py[-1]:
        return order[:1].astype(np.int64)
    # upper half, counter-clockwise: the right chain first
    tl = _sklansky(px, py, 0, maxy, -1, 1)
    tr = _sklansky(px, py, total - 1, maxy, -1, -1)
    tl, tr = tr, tl
    hull = tl[:-1] + tr[:0:-1]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    # lower half
    bl = _sklansky(px, py, 0, miny, 1, -1)
    br = _sklansky(px, py, total - 1, miny, 1, 1)
    if stop >= 0:
        check = (bl[1] if len(bl) > 2 else
                 br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0 and px[check] == px[stop]
                             and py[check] == py[stop]):
            # all points on one line: the lower half mirrors the upper
            bl, br = bl[:2], br[:2]
    hull += bl[:-1] + br[:0:-1]
    idx = [int(order[i]) for i in hull]
    return np.asarray(_ascending_start(idx), np.int64)


def _ascending_start(hull: List[int]) -> List[int]:
    """cv2's final cyclic shift: where the hull's input indices run
    monotonically round the cycle, start at the smallest (ascending) or
    the largest (descending)."""
    n = len(hull)
    if n < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, n):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    dist = abs(max_i - min_i)
    if not ((dist == 1 or dist == n - 1) and (lt <= 1 or lt >= n - 2)):
        return hull
    ascending = (max_i + 1) % n == min_i
    j = min_i if ascending else max_i
    if j == 0:
        return hull
    out = []
    for i in range(n):
        cur = hull[j]
        out.append(cur)
        nj = j + 1 if j + 1 < n else 0
        if i < n - 1 and ascending != (cur < hull[nj]):
            return hull
        j = nj
    return out


def convex_hull(points: np.ndarray) -> Optional[np.ndarray]:
    """The float32 hull vertices (k, 2) as cv2.convexHull(..., clockwise=
    False) returns them, or None where fewer than 3 remain."""
    pts = points.reshape(-1, 2).astype(np.float32)
    hull = pts[_hull_indices(pts)]
    return hull if hull.shape[0] >= 3 else None


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea`` of a float32 contour (k, 2), not oriented."""
    pts = np.asarray(contour, np.float32).reshape(-1, 2)
    if pts.shape[0] == 0:
        return 0.0
    a00 = 0.0
    prev_x, prev_y = float(pts[-1, 0]), float(pts[-1, 1])
    for x, y in pts.tolist():
        a00 += prev_x * y - prev_y * x
        prev_x, prev_y = x, y
    return abs(a00 * 0.5)


def offset_convex_polygon(hull: np.ndarray, dist: float) -> np.ndarray:
    """Exact outward offset of a convex polygon: move each edge along its
    outward normal by `dist` and intersect adjacent offset edges."""
    k = hull.shape[0]
    center = hull.mean(0)
    out = []
    lines = []
    for i in range(k):
        a, b = hull[i], hull[(i + 1) % k]
        e = b - a
        n = np.array([e[1], -e[0]], np.float64)
        n /= max(np.linalg.norm(n), 1e-12)
        if np.dot(n, a - center) < 0:
            n = -n
        lines.append((a + n * dist, b + n * dist))
    for i in range(k):
        p1, p2 = lines[(i - 1) % k]
        p3, p4 = lines[i]
        d1 = p2 - p1
        d2 = p4 - p3
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-9:
            out.append(p3)
            continue
        t = ((p3[0] - p1[0]) * d2[1] - (p3[1] - p1[1]) * d2[0]) / denom
        out.append(p1 + t * d1)
    return np.array(out, np.float64)


def radial_fraction(hull: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                    center: Optional[np.ndarray] = None) -> np.ndarray:
    """t(p) in [0, inf): 0 at center, 1 on the hull boundary, >1 outside."""
    if center is None:
        center = hull.mean(0)
    k = hull.shape[0]
    t = np.full(xs.shape, -np.inf, np.float64)
    for i in range(k):
        a, b = hull[i], hull[(i + 1) % k]
        e = b - a
        n = np.array([e[1], -e[0]], np.float64)
        if np.dot(n, a - center) < 0:
            n = -n
        h = np.dot(n, a - center)
        if h <= 1e-9:
            continue
        t = np.maximum(t, (n[0] * (xs - center[0]) + n[1] * (ys - center[1])) / h)
    return np.clip(t, 0.0, None)


def _min_edge_distance(hull: np.ndarray, xs: np.ndarray, ys: np.ndarray
                       ) -> np.ndarray:
    """Min distance from each pixel to any hull edge SEGMENT (the
    reference's compute_distance, borders.py:167-192: perpendicular distance
    where the foot falls on the segment, else nearest-endpoint distance)."""
    k = hull.shape[0]
    best = np.full(xs.shape, np.inf, np.float64)
    for i in range(k):
        a, b = hull[i], hull[(i + 1) % k]
        d1sq = (xs - a[0]) ** 2 + (ys - a[1]) ** 2
        d2sq = (xs - b[0]) ** 2 + (ys - b[1]) ** 2
        absq = (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
        denom = 2.0 * np.sqrt(np.maximum(d1sq * d2sq, 1e-12))
        cosin = (absq - d1sq - d2sq) / denom
        sinsq = np.clip(1.0 - cosin ** 2, 0.0, None)
        perp = np.sqrt(d1sq * d2sq * sinsq / max(absq, 1e-12))
        d = np.where(cosin < 0, np.sqrt(np.minimum(d1sq, d2sq)), perp)
        best = np.minimum(best, d)
    return best


def _triangle_fan_sizes(hull: np.ndarray, o: np.ndarray, xs: np.ndarray,
                        ys: np.ndarray) -> np.ndarray:
    """(Hc, Wc, 2) size map: each fan triangle (o, v_i, v_i+1) filled with
    |midpoint - o| per axis; the closing triangle (v_k-1, v_0) with the
    scalar L2 norm in both channels (the reference's distance_in_triangle
    loop + tail, borders.py:90-115). fmax-combined like cv2.fillPoly
    overwrites under np.maximum."""
    k = hull.shape[0]
    out = np.zeros((*xs.shape, 2), np.float32)
    for i in range(k):
        a, b = hull[i], hull[(i + 1) % k]
        m = (a + b) / 2.0
        if i < k - 1:
            val = np.abs(m - o)                      # (|dx|, |dy|)
        else:
            val = np.full(2, np.sqrt(np.square(m - o).sum()))
        # point-in-triangle (o, a, b) via signed areas
        d1 = (xs - a[0]) * (o[1] - a[1]) - (ys - a[1]) * (o[0] - a[0])
        d2 = (xs - b[0]) * (a[1] - b[1]) - (ys - b[1]) * (a[0] - b[0])
        d3 = (xs - o[0]) * (b[1] - o[1]) - (ys - o[1]) * (b[0] - o[0])
        neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
        pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
        inside = ~(neg & pos)
        out = np.where(inside[..., None],
                       np.maximum(out, val.astype(np.float32)), out)
    return out


def _window(dilated: np.ndarray, H: int, W: int) -> Tuple[int, int, int, int]:
    """The instance's crop window: the dilated hull's extent, floored and
    ceiled, clipped to the image."""
    x0 = int(max(0, np.floor(dilated[:, 0].min())))
    y0 = int(max(0, np.floor(dilated[:, 1].min())))
    x1 = int(min(W, np.ceil(dilated[:, 0].max()) + 1))
    y1 = int(min(H, np.ceil(dilated[:, 1].max()) + 1))
    return x0, y0, x1, y1


class BorderMasks:
    """Per-image polygon container with map-rendering methods."""

    def __init__(self, polygons: List[List[np.ndarray]]):
        # polygons[i] = list of flat [x0,y0,...] arrays for instance i
        self.polygons = [
            [np.asarray(p, np.float64) for p in inst] for inst in polygons
        ]

    def __len__(self):
        return len(self.polygons)

    def _instance_geometry(self, inst):
        """(float64 hull, dilated hull, area), or None for an instance of
        fewer than 3 hull vertices or of area <= 1."""
        pts = np.concatenate(inst).reshape(-1, 2)
        hull = convex_hull(pts)
        if hull is None:
            return None
        area = contour_area(hull)
        if area <= 1:
            return None
        # float64 hull so the numpy and native renderers see identical edge
        # geometry (float32 edge subtraction flips inside/outside at the
        # boundary between the two otherwise)
        hull = hull.astype(np.float64)
        dilated = offset_convex_polygon(hull, np.sqrt(area) * 0.1)
        return hull, dilated, area

    def center_masks(self, mask_size: Tuple[int, int], standard: str = "gaussian",
                     sigma: float = 0.5) -> np.ndarray:
        """(H, W) float map: max over instances of the center score."""
        H, W = mask_size
        out = np.zeros((H, W), np.float32)
        for inst in self.polygons:
            geo = self._instance_geometry(inst)
            if geo is None:
                continue
            hull, dilated, _ = geo
            x0, y0, x1, y1 = _window(dilated, H, W)
            if x1 <= x0 or y1 <= y0:
                continue
            if (USE_NATIVE and _native.available()
                    and _native.render_center_score(
                        hull, hull.mean(0), standard, sigma,
                        (x0, y0, x1, y1), out)):
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1, dtype=np.float64),
                                 np.arange(y0, y1, dtype=np.float64))
            # the reference ramps over the HULL fan (center_masks,
            # borders.py:233-263), the dilation only widens the crop window
            t = radial_fraction(hull, xs, ys)
            if standard == "linear":
                score = np.clip(1.0 - t, 0.0, 1.0)
            else:
                score = np.where(t <= 1.0, np.exp(-(t ** 2) / (2 * sigma ** 2)),
                                 0.0)
            out[y0:y1, x0:x1] = np.fmax(out[y0:y1, x0:x1],
                                        score.astype(np.float32))
        return out

    def masks(self, mask_size: Tuple[int, int]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Renders the reference's three supervision maps
        (`BorderMasks.masks`/`border_masks`, borders.py:291-390):

        - border (H, W): fmax of (a) the border-proximity band
          clip(1 - d_edge/dilate_dist, 0, 1) over the dilated window
          (draw_border_map, :125-164) and (b) the inside linear ramp
          0@center -> 1@hull-boundary (mask_in_triangle reverse=False);
        - center (H, W): the reverse linear ramp 1@center -> 0@boundary;
        - size (H, W, 2): per triangle (O, v_i, v_i+1) of the hull fan, the
          per-axis |midpoint(v_i, v_i+1) - O|, with the reference's quirk
          that the closing triangle is filled with the scalar L2 distance in
          BOTH channels (distance_in_triangle, :90-115).
        """
        H, W = mask_size
        border = np.zeros((H, W), np.float32)
        center = np.zeros((H, W), np.float32)
        sizes = np.zeros((H, W, 2), np.float32)
        for inst in self.polygons:
            geo = self._instance_geometry(inst)
            if geo is None:
                continue
            hull, dilated, area = geo
            x0, y0, x1, y1 = _window(dilated, H, W)
            if x1 <= x0 or y1 <= y0:
                continue
            o = hull.mean(0)
            dilate_dist = np.sqrt(max(area, 0.0)) * 0.1
            if (USE_NATIVE and _native.available()
                    and _native.render_instance_maps(
                        hull, o, dilate_dist, (x0, y0, x1, y1),
                        border, center, sizes)):
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1, dtype=np.float64),
                                 np.arange(y0, y1, dtype=np.float64))
            t = radial_fraction(hull, xs, ys, center=o)
            inside = t <= 1.0

            # (a) border-proximity band over the dilated window
            d_edge = _min_edge_distance(hull, xs, ys)
            band = np.clip(1.0 - d_edge / max(dilate_dist, 1e-9), 0.0, 1.0)
            # (b) inside ramp
            ramp = np.where(inside, t, 0.0)
            border[y0:y1, x0:x1] = np.fmax(
                border[y0:y1, x0:x1],
                np.fmax(band, ramp).astype(np.float32),
            )

            center[y0:y1, x0:x1] = np.fmax(
                center[y0:y1, x0:x1],
                np.where(inside, 1.0 - t, 0.0).astype(np.float32),
            )

            size_inst = _triangle_fan_sizes(hull, o, xs, ys)
            sizes[y0:y1, x0:x1] = np.fmax(sizes[y0:y1, x0:x1], size_inst)
        return border, center, sizes

    def border_masks(self, mask_size: Tuple[int, int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(border, sizes) pair; see masks()."""
        border, _, sizes = self.masks(mask_size)
        return border, sizes
