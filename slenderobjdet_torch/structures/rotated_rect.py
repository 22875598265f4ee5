"""Rotated-rectangle geometry as OpenCV 5.0 computes it, in numpy and Python
floats (no cv2: the card's machine does not have it): ``min_area_rect``
(``cv2.minAreaRect``) and ``rectangle_intersection``
(``cv2.rotatedRectangleIntersection``).

cv2 takes the counter-clockwise convex hull of the float32 points
(``borders._hull_indices``, the transcription of ``cv2.convexHull``) and
runs rotating calipers over it (``modules/geometry/src/rotcalipers.cpp``;
the steps below were read from the compiled ``cv2.minAreaRect``):

- each hull edge ``v[i] = p[i + 1] - p[i]`` in float32 and its inverse
  length ``(float)(1 / sqrt((double) dx^2 + (double) dy^2))``;
- the calipers start at the first bottom, right, top and left vertex (the
  first strict minimum of y, maximum of x, maximum of y, minimum of x);
- a step turns the caliper whose next edge makes the smallest angle with
  it: the four edges are rotated into the first caliper's frame (``v0``,
  ``(v1.y, -v1.x)``, ``(-v2.x, -v2.y)``, ``(-v3.y, v3.x)``) and, from the
  first, the next replaces the candidate where the float32 cross product
  ``c.x * e.y - c.y * e.x`` is below 0 (ties keep the earlier caliper);
  the new base is that edge's unit vector, and the rectangle's width and
  height are the float32 projections of the caliper points' differences;
- of the ``n`` rectangles the last of the smallest area (``<=``) wins; its
  corner is the intersection of two caliper lines in float32.

The result, ``((cx, cy), (w, h), angle)``: with ``o1 = base * width`` and
``o2 = base' * height`` (the rectangle's two sides from the corner), the
size is ``(|o2|, |o1|)`` and the angle ``atan2(o1.x, o1.y) * -180 / pi``
in [-90, 0), except that a side ``o1`` pointing straight down (x 0, y > 0)
gives ``(|o1|, |o2|)`` at -90. Two distinct hull points give a degenerate
rectangle along their segment, one point a rectangle of size 0 there.
Every float32 operation is rounded as cv2 rounds it, so the results are
cv2's bit for bit (``tests/test_torch_rotated_geometry.py``).

``rectangle_intersection`` (``modules/geometry/src/intersection.cpp``, read
from the compiled function): both rectangles are moved by the mean of their
centres (float32) and their corners formed as ``RotatedRect::points`` does
(``sin`` and ``cos`` of ``angle * pi / 180`` in double, halved in float32;
``p2 = (c + a h) + b w``, ``p3 = (c - a h) + b w`` componentwise). Within
``eps = 1e-6 * max area`` corner by corner the rectangles are the same
(INTERSECT_FULL, rectangle 1's corners). Otherwise every pair of edges that
is not parallel (``|det| >= 1e-12``) meets at ``p1 + v1 * t1`` where both
parameters, ``cross * (1 / det)`` in float32, lie in [0, 1]; each corner of
one rectangle on the same side of all four edges of the other (``(q.x -
p.x) * v.y >= (q.y - p.y) * v.x`` four times or none) is added; points
within ``eps`` (squared distance; eps first lowered to the shortest edge,
at least 1e-16) of an earlier one are dropped (the last point moving into
the gap), then the closest pairs while more than 8 remain; the rest is
ordered by a double-precision cross-product sort and moved back.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .borders import _hull_indices

_FLT_MAX = float(np.finfo(np.float32).max)
Rect = Tuple[Tuple[float, float], Tuple[float, float], float]


def _f(x: float) -> float:
    """Round a Python float (double) to float32: one float32 operation."""
    return float(np.float32(x))


def _calipers(p: Sequence[Tuple[float, float]]):
    """The corner and the two sides (o1, o2) of the minimum-area rectangle
    of a counter-clockwise hull of more than 2 vertices."""
    n = len(p)
    vect: List[Tuple[float, float]] = []
    inv: List[float] = []
    left = bottom = right = top = 0
    left_x = right_x = p[0][0]
    top_y = bottom_y = p[0][1]
    for i in range(n):
        x, y = p[i]
        if x < left_x:
            left_x, left = x, i
        if x > right_x:
            right_x, right = x, i
        if y > top_y:
            top_y, top = y, i
        if y < bottom_y:
            bottom_y, bottom = y, i
        q = p[i + 1 if i + 1 < n else 0]
        dx, dy = _f(q[0] - x), _f(q[1] - y)
        vect.append((dx, dy))
        inv.append(_f(1.0 / math.sqrt(dx * dx + dy * dy)))

    seq = [bottom, right, top, left]
    min_area, best = _FLT_MAX, None
    for _ in range(n):
        v = [vect[s] for s in seq]
        edges = (v[0], (v[1][1], -v[1][0]), (-v[2][0], -v[2][1]), (-v[3][1], v[3][0]))
        c, main = edges[0], 0
        for j in (1, 2, 3):
            e = edges[j]
            if _f(_f(c[0] * e[1]) - _f(c[1] * e[0])) < 0:
                c, main = e, j
        s = seq[main]
        lx, ly = _f(vect[s][0] * inv[s]), _f(vect[s][1] * inv[s])
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = s + 1 if s + 1 < n else 0

        dx, dy = _f(p[seq[1]][0] - p[seq[3]][0]), _f(p[seq[1]][1] - p[seq[3]][1])
        width = _f(_f(dx * base_a) + _f(dy * base_b))
        dx, dy = _f(p[seq[2]][0] - p[seq[0]][0]), _f(p[seq[2]][1] - p[seq[0]][1])
        height = _f(_f(dy * base_a) - _f(dx * base_b))
        area = _f(width * height)
        if area <= min_area:
            min_area = area
            best = (seq[3], base_a, width, base_b, height, seq[0])

    s3, a1, width, b1, height, s0 = best
    a2, b2 = -b1, a1
    c1 = _f(_f(a1 * p[s3][0]) + _f(p[s3][1] * b1))
    c2 = _f(_f(a2 * p[s0][0]) + _f(p[s0][1] * b2))
    idet = _f(1.0 / _f(_f(a1 * b2) - _f(a2 * b1)))
    px = _f(_f(_f(c1 * b2) - _f(c2 * b1)) * idet)
    py = _f(_f(_f(a1 * c2) - _f(a2 * c1)) * idet)
    return (px, py), (_f(a1 * width), _f(b1 * width)), (_f(a2 * height), _f(b2 * height))


def min_area_rect(points: np.ndarray) -> Rect:
    """``cv2.minAreaRect(points)`` for (N, 2) points (cast to float32):
    ``((cx, cy), (w, h), angle_degrees)`` as Python floats."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float32)
    hull = [(float(x), float(y)) for x, y in pts[_hull_indices(pts)]]
    n = len(hull)
    cx = cy = w = h = 0.0
    angle = -90.0
    if n > 2:
        (px, py), o1, o2 = _calipers(hull)
        cx = _f(_f(_f(o1[0] + o2[0]) * 0.5) + px)
        cy = _f(_f(_f(o1[1] + o2[1]) * 0.5) + py)
        l1 = _f(math.sqrt(o1[0] * o1[0] + o1[1] * o1[1]))
        l2 = _f(math.sqrt(o2[0] * o2[0] + o2[1] * o2[1]))
        if o1[0] == 0 and o1[1] > 0:
            w, h = l1, l2
        else:
            w, h = l2, l1
            angle = _f(math.atan2(o1[0], o1[1]) * -180.0 / math.pi)
    elif n == 2:
        (x0, y0), (x1, y1) = hull
        cx, cy = _f(_f(x1 + x0) * 0.5), _f(_f(y1 + y0) * 0.5)
        dx, dy = _f(x0 - x1), _f(y0 - y1)
        length = _f(math.sqrt(dx * dx + dy * dy))
        w, h = 0.0, length
        if dx == 0:
            w, h = length, 0.0
        elif dy < 0:
            w, h = length, 0.0
            angle = _f(math.atan2(dy, dx) * 180.0 / math.pi)
        elif dy > 0:
            angle = _f(math.atan2(dx, dy) * -180.0 / math.pi)
    elif n == 1:
        cx, cy = hull[0]
    return (cx, cy), (w, h), angle


_HALF = np.float32(0.5)
_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)
_F32_MAX = np.float32(_FLT_MAX)


def _rect_points(center, size, angle):
    cx, cy = center
    w, h = size
    theta = float(angle) * math.pi / 180.0
    a = np.float32(math.sin(theta)) * _HALF
    b = np.float32(math.cos(theta)) * _HALF
    ah, bh, bw, aw = a * h, b * h, b * w, a * w
    return [(cx - ah - bw, cy + bh - aw), (cx + ah - bw, cy - bh - aw),
            (cx + ah + bw, cy - bh + aw), (cx - ah + bw, cy + bh + aw)]


def _intersection(center1, size1, angle1, center2, size2, angle2):
    eps = np.float32(1e-6) * max(size2[0] * size2[1], size1[0] * size1[1])
    pts1 = _rect_points(center1, size1, angle1)
    pts2 = _rect_points(center2, size2, angle2)
    if all(abs(pts1[i][0] - pts2[i][0]) <= eps and abs(pts1[i][1] - pts2[i][1]) <= eps
           for i in range(4)):
        return 2, list(pts1)
    vec1 = [(pts1[(i + 1) % 4][0] - pts1[i][0], pts1[(i + 1) % 4][1] - pts1[i][1])
            for i in range(4)]
    vec2 = [(pts2[(i + 1) % 4][0] - pts2[i][0], pts2[(i + 1) % 4][1] - pts2[i][1])
            for i in range(4)]
    for i in range(4):
        for v in (vec1[i], vec2[i]):
            eps = min(eps, np.sqrt(v[0] * v[0] + v[1] * v[1]))
    eps = max(eps, np.float32(1e-16))

    found = []
    with np.errstate(all="ignore"):
        for i in range(4):
            vx1, vy1 = vec1[i]
            for j in range(4):
                vx2, vy2 = vec2[j]
                det = vx2 * vy1 - vy2 * vx1
                if abs(float(det)) < 1e-12:
                    continue
                inv = _ONE / det
                x21, y21 = pts2[j][0] - pts1[i][0], pts2[j][1] - pts1[i][1]
                t1 = (vx2 * y21 - vy2 * x21) * inv
                t2 = (vx1 * y21 - vy1 * x21) * inv
                if not (abs(t1) <= _F32_MAX and abs(t2) <= _F32_MAX):
                    continue
                if _ZERO <= t1 <= _ONE and _ZERO <= t2 <= _ONE:
                    found.append((t1 * vx1 + pts1[i][0], t1 * vy1 + pts1[i][1]))
    ret = 1 if found else 2
    for own, other, edges in ((pts1, pts2, vec2), (pts2, pts1, vec1)):
        for x, y in own:
            pos = sum(bool((q[0] - x) * v[1] >= (q[1] - y) * v[0])
                      for q, v in zip(other, edges))
            if pos in (0, 4):
                found.append((x, y))
    n = len(found)
    if n == 0:
        return 0, []

    stride = n
    dist = [None] * (n * n)
    remap = list(range(n))
    i = 0
    while i < n:
        x0, y0 = found[i]
        remap[i] = i
        j = i + 1
        while j < n:
            dx, dy = found[j][0] - x0, found[j][1] - y0
            d2 = dx * dx + dy * dy
            if d2 <= eps:
                n -= 1
                if j < n:
                    found[j] = found[n]
                continue
            dist[i * stride + j] = d2
            j += 1
        i += 1
    while n > 8:
        min_i, min_j, min_d = 0, 1, dist[1]
        for i in range(n - 1):
            for j in range(i + 1, n):
                d = dist[stride * remap[i] + remap[j]]
                if d < min_d:
                    min_d, min_i, min_j = d, i, j
        if min_j < n - 1:
            found[min_j] = found[n - 1]
            remap[min_j] = remap[n - 1]
        n -= 1
    found = found[:n]
    for i in range(n - 1):
        di = (found[i + 1][0] - found[i][0], found[i + 1][1] - found[i][1])
        for j in range(i + 2, n):
            dj = (found[j][0] - found[i][0], found[j][1] - found[i][1])
            if float(di[0]) * float(dj[1]) - float(di[1]) * float(dj[0]) < 0:
                found[i + 1], found[j] = found[j], found[i + 1]
                di = dj
    return ret, found


def rectangle_intersection(rect1: Rect, rect2: Rect):
    """``cv2.rotatedRectangleIntersection(rect1, rect2)`` for rectangles
    ``((cx, cy), (w, h), angle_degrees)`` (cv2's clockwise angle): (0 none, 1
    partial or 2 full, the region's vertices as an (n, 2) float32 array)."""
    (c1, s1, a1), (c2, s2, a2) = rect1, rect2
    c1 = (np.float32(c1[0]), np.float32(c1[1]))
    c2 = (np.float32(c2[0]), np.float32(c2[1]))
    s1 = (np.float32(s1[0]), np.float32(s1[1]))
    s2 = (np.float32(s2[0]), np.float32(s2[1]))
    if min(s1[0], s1[1], s2[0], s2[1]) <= 0:
        return 0, np.zeros((0, 2), np.float32)
    sx, sy = (c1[0] + c2[0]) * _HALF, (c1[1] + c2[1]) * _HALF
    ret, pts = _intersection((c1[0] - sx, c1[1] - sy), s1, np.float32(a1),
                             (c2[0] - sx, c2[1] - sy), s2, np.float32(a2))
    return ret, np.array([(x + sx, y + sy) for x, y in pts], np.float32).reshape(-1, 2)
