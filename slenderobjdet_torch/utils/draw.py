"""Raster primitives of the visualizer without cv2 (the card's machine has none).

Each function transcribes the OpenCV 5.0 routine named beside it and gives
its pixels on uint8 (H, W, C) images: ``tests/test_torch_visualizer.py``
holds them pixel-equal to cv2 5.0 on seeded and hypothesis-drawn shapes,
shapes clipped at the image border included. Only what the JAX package's
visualizer calls is here: ``LINE_8`` on integer points (no fractional
shift).

- ``line``: ``cv2.line`` (``ThickLine``): at thickness 1 ``LineIterator``,
  8-connected, walked left to right after ``clipLine``; thicker, the
  segment clipped to the image grown by the thickness, the quadrilateral
  half the thickness either side filled by ``FillConvexPoly`` in 16.16
  fixed point (its outline by OpenCV 5.0's ``Line2``) and a filled circle
  capping each end;
- ``polylines`` and ``rectangle``: ``cv2.polylines`` / ``cv2.rectangle``,
  one ``line`` an edge, capped as ``PolyLine`` caps them;
- ``fill_poly``: ``cv2.fillPoly`` (``CollectPolyEdges``, which also draws
  each edge as a ``line``, then the scan of ``FillEdgeCollection`` in 16.16
  fixed point);
- ``circle_filled``: ``cv2.circle`` with thickness -1 (the midpoint
  ``Circle`` filled by horizontal runs);
- ``add_weighted``: ``cv2.addWeighted`` on uint8 (float32 fused
  multiply-adds, rounded half to even);
- ``resize_linear``: ``cv2.resize`` with ``INTER_LINEAR`` on uint8 (11-bit
  fixed-point weights, the vectorised vertical pass's rounding; a 2x
  reduction is ``INTER_AREA``'s mean of 2 x 2);
- ``box_points``: ``cv2.boxPoints`` (``RotatedRect::points`` in float32);
- ``put_text``: ``cv2.putText`` with ``FONT_HERSHEY_SIMPLEX`` and thickness 1
  at the scales of ``utils/glyphs.py``. OpenCV 5.0 draws the Hershey faces
  with an embedded TrueType font (``hersheyToTruetype``): each glyph is an
  8-bit coverage bitmap blended into the image in turn at an integer pen
  position, ``round(d + (c - d) * a / 255)``, and the pen moves by the
  glyph's integer advance. The table holds those bitmaps and advances as
  cv2 renders them (``tools/make_torch_glyph_table.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
INT_MAX = 2 ** 31 - 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """``cv::clipLine``: whether any of the segment lies inside [0, w) x
    [0, h), and its end points moved onto the border as the C++ routine
    leaves them (moved or not, whatever the answer)."""
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, ((x1, y1), (x2, y2))
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, ((x1, y1), (x2, y2))


def line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """The (ys, xs) that ``cv::LineIterator(img, p1, p2, 8, true)`` visits."""
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, ((x1, y1), (x2, y2)) = clip_line(w, h, (x1, y1), (x2, y2))
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:                                  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    ystep = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    count = dx + 1
    # the iterator's error term starts at dx - 2 dy; a step also moves the
    # minor axis while it is negative. k: the minor axis's moves so far
    k = np.zeros(count, np.int64)
    if dy > 0:
        err, moved = dx - 2 * dy, 0
        for j in range(1, count):
            if err < 0:
                moved += 1
                err += 2 * dx - 2 * dy
            else:
                err -= 2 * dy
            k[j] = moved
    i = np.arange(count, dtype=np.int64)
    if steep:
        return y1 + ystep * i, x1 + k
    return y1 + ystep * k, x1 + i


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness)`` in place (``LINE_8``)."""
    return _thick_line(img, p1, p2, color, thickness, 3)


def polylines(img: np.ndarray, polys: Sequence, closed: bool, color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, polys, closed, color, thickness)`` in place
    (``PolyLine``: a closed polygon caps each edge's end, an open one also
    the first edge's start)."""
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if not pts:
            continue
        flags = 2 + (not closed)
        p0 = pts[len(pts) - 1 if closed else 0]
        for p in pts[0 if closed else 1:]:
            _thick_line(img, p0, p, color, thickness, flags)
            p0, flags = p, 2
    return img


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` in place (thickness
    >= 1: the closed polyline of its four corners)."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    return polylines(img, [[(x1, y1), (x2, y1), (x2, y2), (x1, y2)]], True, color, thickness)


def _thick_line(img, p0, p1, color, thickness: int, flags: int):
    """``ThickLine`` for integer points, ``LINE_8``: thickness 1 is the
    8-connected ``line``; a thicker one is the convex quadrilateral of the
    segment pushed out by half the thickness in 16.16 fixed point, filled,
    and a filled circle at each end whose bit is set in ``flags`` (1: the
    start, 2: the end)."""
    h, w = img.shape[:2]
    if thickness <= 1:
        ys, xs = line_pixels(w, h, p0, p1)
        img[ys, xs] = color
        return img
    # OpenCV 5.0 first clips the segment to the image grown by the
    # thickness on every side (``clipLine``'s moved ends, drawn either way)
    m = thickness
    _, ((x0, y0), (x1, y1)) = clip_line(w + 2 * m, h + 2 * m, (int(p0[0]) + m, int(p0[1]) + m),
                                        (int(p1[0]) + m, int(p1[1]) + m))
    x0, y0 = (x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT
    x1, y1 = (x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))   # cvRound: half to even
        _fill_convex_poly(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                                (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], color)
    for bit, (x, y) in ((1, (x0, y0)), (2, (x1, y1))):
        if flags & bit:
            center = ((x + (XY_ONE >> 1)) >> XY_SHIFT, (y + (XY_ONE >> 1)) >> XY_SHIFT)
            circle_filled(img, center, (half + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return img


def _line_fixed(img, p1, p2, color):
    """``Line2`` as OpenCV 5.0 draws a convex polygon's outline: the
    16.16 fixed-point segment, clipped, walked along its major axis from its
    end of the smaller major coordinate, rounded, in (end - start) >> 16 + 1
    steps of one pixel, the minor coordinate rounded at each; the other
    end's rounded pixel is set too."""
    h, w = img.shape[:2]
    ok, ((x1, y1), (x2, y2)) = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    half = XY_ONE >> 1
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if (dx if x_major else dy) < 0:
        x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
    k = np.arange(((x2 - x1) if x_major else (y2 - y1)) // XY_ONE + 1, dtype=object)
    if x_major:
        xs = ((x1 + half) >> XY_SHIFT) + k
        ys = (y1 + half + k * _cdiv(dy << XY_SHIFT, abs(dx) | 1)) >> XY_SHIFT
    else:
        xs = (x1 + half + k * _cdiv(dx << XY_SHIFT, abs(dy) | 1)) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> XY_SHIFT).astype(np.int64)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _fill_convex_poly(img, v, color):
    """``FillConvexPoly`` for 16.16 fixed-point points, ``LINE_8``: the
    outline by ``Line2``, then per row the span between the two edges that
    walk down from the top vertex, both ends rounded to the nearest pixel."""
    h, w = img.shape[:2]
    delta = XY_ONE >> 1
    npts = len(v)
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = int(np.argmin(ys))             # the first of the top vertices
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "ye": ymin, "x": -XY_ONE, "dx": 0},
            {"idx": imin, "di": npts - 1, "ye": ymin, "x": -XY_ONE, "dx": 0}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs0
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1            # the C loop's test decrements once more
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_poly_edges(img, pts, edges, color):
    """``CollectPolyEdges`` for integer points, ``LINE_8``, no shift."""
    h, w = img.shape[:2]
    pt0 = (pts[-1][0] << XY_SHIFT, pts[-1][1])
    for p in pts:
        pt1 = (p[0] << XY_SHIFT, p[1])
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        line(img, t0, t1, color)
        pt0c, pt1c = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # a clipped edge takes the clipped x's always, and the clipped
            # y's only where they differ (else it keeps its own rows and
            # runs straight down the border column)
            _, (c0, c1) = clip_line(w, h, t0, t1)
            if c0[1] != c1[1]:
                pt0c[1], pt1c[1] = c0[1], c1[1]
            pt0c[0], pt1c[0] = c0[0] << XY_SHIFT, c1[0] << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _cdiv(pt1c[0] - pt0c[0], pt1c[1] - pt0c[1])
            if pt0[1] < pt1[1]:
                edges.append(_Edge(pt0[1], pt1[1], pt0c[0] + (pt0[1] - pt0c[1]) * dx, dx))
            else:
                edges.append(_Edge(pt1[1], pt0[1], pt1c[0] + (pt1[1] - pt1c[1]) * dx, dx))
        pt0 = pt1


def _fill_edge_collection(img, edges, color):
    """``FillEdgeCollection`` for ``LINE_8``."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min, y_max = INT_MAX, -INT_MAX - 1
    x_min, x_max = 2 ** 63 - 1, -1
    for e in edges:
        x1 = e.x + (e.y1 - e.y0) * e.dx
        y_min, y_max = min(y_min, e.y0), max(y_max, e.y1)
        x_min, x_max = min(x_min, e.x, x1), max(x_max, e.x, x1)
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(INT_MAX))
    tmp = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        draw = False
        clipline = y < 0
        prelast, last = tmp, tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next            # the edge ends here
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next     # next edge of the active list
            elif i < total:
                prelast.next = e                    # the edge starts here
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    # the pixels whose centres lie within [left x, right x]
                    if keep_prelast.x > prelast.x:
                        x1, x2 = (prelast.x + XY_ONE - 1) >> XY_SHIFT, keep_prelast.x >> XY_SHIFT
                    else:
                        x1, x2 = (keep_prelast.x + XY_ONE - 1) >> XY_SHIFT, prelast.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = tmp, tmp.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def fill_poly(img: np.ndarray, polys: Sequence, color) -> np.ndarray:
    """``cv2.fillPoly(img, polys, color)`` in place (integer points)."""
    edges = []
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if pts:
            _collect_poly_edges(img, pts, edges, color)
    _fill_edge_collection(img, edges, color)
    return img


def circle_filled(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    inside = cx >= radius and cx < w - radius and cy >= radius and cy < h - radius

    def hline(y, x1, x2):
        img[y, x1:x2 + 1] = color

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            hline(y11, x11, x12)
            hline(y12, x11, x12)
            hline(y21, x21, x22)
            hline(y22, x21, x22)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                hline(y11, x11, x12)
            if 0 <= y12 < h:
                hline(y12, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    hline(y21, x21, x22)
                if 0 <= y22 < h:
                    hline(y22, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``: the exact product and sum in float64 (a
    uint8 times a float32 is exact there), rounded once."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """``cv2.addWeighted`` on uint8: ``fma(a, alpha, fma(b, beta, gamma))``
    in float32, rounded half to even and saturated."""
    a, b = np.float32(alpha), np.float32(beta)
    g = np.full(src2.shape, np.float32(gamma), np.float32)
    t = _fma32(src1, a, _fma32(src2, b, g))
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


RESIZE_COEF_BITS = 11
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


def _linear_taps(dst: int, src: int, clamp: bool):
    """Per destination index: the first source index and its two 11-bit
    weights (``resizeGeneric``'s ``xofs`` / ``ialpha`` and ``yofs`` /
    ``ibeta`` tables), and, along x, the index from which the second tap
    falls off the end (``xmax``). Along x a source index outside the image
    is clamped with its weight set to the one tap (``clamp``); along y the
    weights stay and the rows are clamped when they are read."""
    scale = 1.0 / (dst / src)
    ofs = np.zeros(dst, np.int64)
    w0 = np.zeros(dst, np.int64)
    w1 = np.zeros(dst, np.int64)
    xmax = dst
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        f = np.float32(f - np.float32(s))
        if clamp:
            if s < 0:
                f, s = np.float32(0), 0
            if s + 1 >= src:
                xmax = min(xmax, d)
                if s >= src - 1:
                    f, s = np.float32(0), src - 1
        ofs[d] = s
        w0[d] = int(np.rint(np.float32(np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)))
        w1[d] = int(np.rint(f * np.float32(RESIZE_COEF_SCALE)))
    return ofs, w0, w1, xmax


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh)`` (``INTER_LINEAR``) for uint8 images."""
    nw, nh = int(size_wh[0]), int(size_wh[1])
    h, w = img.shape[:2]
    if img.ndim == 3 and img.shape[2] == 1:     # cv2 returns a single channel as (H, W)
        img = img[:, :, 0]
    src = img.reshape(h, w, -1).astype(np.int64)
    cn = src.shape[2]
    if (nw, nh) == (w, h):
        return img.copy()
    if w == 2 * nw and h == 2 * nh:             # INTER_AREA's 2 x 2 mean
        s = (src[0::2, 0::2] + src[1::2, 0::2] + src[0::2, 1::2] + src[1::2, 1::2] + 2) >> 2
        return s.astype(np.uint8).reshape((nh, nw) + img.shape[2:])
    xofs, a0, a1, xmax = _linear_taps(nw, w, clamp=True)
    yofs, b0, b1, _ = _linear_taps(nh, h, clamp=False)
    # horizontal pass: exact int sums (the last tap alone where the second falls off)
    nxt = np.minimum(xofs + 1, w - 1)
    rows = src[:, xofs] * a0[None, :, None] + src[:, nxt] * a1[None, :, None]
    rows[:, xmax:] = src[:, xofs[xmax:]] * RESIZE_COEF_SCALE
    r0 = rows[np.clip(yofs, 0, h - 1)]
    r1 = rows[np.clip(yofs + 1, 0, h - 1)]
    # vertical pass in the vectorised form on every element (cv2 5.0 runs
    # no scalar tail here): (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    out = (((b0[:, None, None] * (r0 >> 4)) >> 16)
           + ((b1[:, None, None] * (r1 >> 4)) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((nh, nw) + img.shape[2:])


def box_points(center, size, angle) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: (4, 2) float32, the
    corners of ``structures/rotated_rect.py`` on float32 inputs."""
    from ..structures.rotated_rect import _rect_points

    f = np.float32
    pts = _rect_points((f(center[0]), f(center[1])), (f(size[0]), f(size[1])), f(angle))
    return np.array(pts, np.float32)


def put_text(img: np.ndarray, text: str, org, scale: float, color) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color, 1)``
    in place: each glyph's coverage blended in turn, clipped to the image."""
    from .glyphs import glyph_table

    table = glyph_table(scale)
    h, w = img.shape[:2]
    col = np.asarray(color, np.float64)[:img.shape[2] if img.ndim == 3 else 1]
    x, y = int(org[0]), int(org[1])
    for ch in text:
        code = ord(ch)
        if code not in table:
            raise ValueError(f"put_text: no glyph for {ch!r} (printable ASCII only)")
        adv, gx, gy, cov = table[code]
        if cov.size:
            y0, x0 = y + gy, x + gx
            ys0, xs0 = max(y0, 0), max(x0, 0)
            ys1, xs1 = min(y0 + cov.shape[0], h), min(x0 + cov.shape[1], w)
            if ys0 < ys1 and xs0 < xs1:
                a = cov[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0].astype(np.float64)
                region = img[ys0:ys1, xs0:xs1]
                d = region.astype(np.float64)
                if img.ndim == 3:
                    a = a[..., None]
                img[ys0:ys1, xs0:xs1] = np.floor(d + (col - d) * a / 255.0 + 0.5).astype(img.dtype)
        x += adv
    return img
