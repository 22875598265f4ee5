"""The port's border / center / size maps (``slenderobjdet_torch/structures/
borders.py``, its C renderer ``csrc/border_render.c`` and loader
``native.py``) and the mapper's NEED_MASKS branch, held against cv2 and the
JAX package on the CPU:

- ``convex_hull`` and ``contour_area`` equal ``cv2.convexHull(points,
  clockwise=False)`` and ``cv2.contourArea`` vertex for vertex and bit for
  bit: random clouds, grids with collinear runs and duplicates, points on a
  line and near it in float32, fewer than 3 distinct points, ordered
  polygons and slender ones. The start vertex matters (the last fan
  triangle carries the L2 size), so the sequences are compared as they are;
- ``BorderMasks.center_masks`` (gaussian and linear), ``masks`` and
  ``border_masks`` bit-equal to the JAX package's, numpy renderer against
  numpy renderer and C against C; within the port, C against numpy to the
  tolerances of ``tests/test_border_native.py``;
- the mapper's ``center_mask``, ``border_mask`` and ``size_map`` bit-equal to
  the JAX mapper's on inlined dicts with integer-vertex polygons, flipped and
  not, in both buckets, for FCOSV3 and ProposalNetworkWithMasks, and still
  bit-equal without cv2.

Every input comes from a numpy generator seeded in its test.
"""

import logging

import cv2
import numpy as np
import pytest

from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.data import mapper as tmapper
from slenderobjdet_torch.data import transforms as tT
from slenderobjdet_torch.structures import borders as tborders
from slenderobjdet_torch.structures import native as tnative
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.data import mapper as jmapper
from slenderobjdet_tpu.structures import borders as jborders
from slenderobjdet_tpu.structures import native as jnative

CANVAS = (240, 320)
MAP_ATOL = 1e-5       # tests/test_border_native.py: border and center maps
SIZE_ATOL = 1e-3      # and the size map, C renderer against numpy


# ------------------------------------------------------------------ hull
def _cloud(rs, kind):
    m = rs.randint(1, 60)
    if kind == "cloud":
        return rs.rand(m, 2) * 100
    if kind == "grid":                         # collinear runs and duplicates
        return rs.randint(0, 6, (m, 2)).astype(np.float64)
    if kind == "line":                         # every point on y = 2x + 1
        t = rs.randint(0, 20, m).astype(np.float64)
        return np.stack([t, 2 * t + 1], 1)
    if kind == "near_line":                    # on it up to float32 rounding
        t = rs.rand(m) * 10
        return np.stack([t, 2 * t + 1], 1)
    if kind == "few":                          # 1 or 2 distinct points
        base = rs.rand(rs.randint(1, 3), 2) * 50
        return base[rs.randint(0, len(base), m)]
    if kind == "polygon":                      # ordered either way, any start
        ang = np.sort(rs.rand(m) * 2 * np.pi)
        r = rs.rand(m) * 30 + 5
        pts = np.stack([50 + r * np.cos(ang), 40 + r * np.sin(ang)], 1)
        return np.roll(pts[::-1] if rs.rand() < 0.5 else pts, rs.randint(m), 0)
    if kind == "slender":                      # aspect 8-400, two decimals
        c, a = rs.rand(2) * 500, rs.rand() * np.pi
        u = (rs.rand(m) - 0.5) * (rs.rand() * 200 + 40)
        v = (rs.rand(m) - 0.5) * (rs.rand() * 4 + 0.5)
        return np.round(np.stack([c[0] + u * np.cos(a) - v * np.sin(a),
                                  c[1] + u * np.sin(a) + v * np.cos(a)], 1), 2)
    # "repeated": polygons whose vertices repeat
    base = rs.randint(0, 50, (max(m // 2, 1), 2)).astype(np.float64)
    return base[rs.randint(0, len(base), m)]


@pytest.mark.parametrize("kind", ["cloud", "grid", "line", "near_line", "few", "polygon",
                                  "slender", "repeated"])
def test_convex_hull_and_area_equal_cv2(kind):
    rs = np.random.RandomState(["cloud", "grid", "line", "near_line", "few", "polygon",
                                "slender", "repeated"].index(kind))
    n_hulls = 0
    for _ in range(600):
        pts = _cloud(rs, kind)
        want = cv2.convexHull(pts.astype(np.float32), clockwise=False).reshape(-1, 2)
        got = tborders.convex_hull(pts)
        if want.shape[0] < 3:
            # one or two vertices: no hull for the maps, but the same ones
            assert got is None
            np.testing.assert_array_equal(
                pts.astype(np.float32)[tborders._hull_indices(pts)], want)
            continue
        n_hulls += 1
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert tborders.contour_area(got) == cv2.contourArea(want)
    if kind in ("line", "few"):
        assert n_hulls == 0
    else:
        assert n_hulls > 500


def test_contour_area_of_any_contour_equals_cv2():
    """Self-intersecting and repeated-vertex contours too: the shoelace sum
    in cv2's order, float32 vertices, float64 accumulation."""
    rs = np.random.RandomState(9)
    for _ in range(500):
        pts = (rs.rand(rs.randint(1, 30), 2) * 1000).astype(np.float32)
        assert tborders.contour_area(pts) == cv2.contourArea(pts)
    assert tborders.contour_area(np.zeros((0, 2), np.float32)) == 0.0


# ------------------------------------------------------------------ maps
def _random_polys(rs, n=6, canvas=CANVAS):
    """tests/test_border_native.py's draw: 4-8 vertices round a centre."""
    H, W = canvas
    polys = []
    for _ in range(n):
        cx, cy = rs.rand() * (W - 80) + 40, rs.rand() * (H - 80) + 40
        m = rs.randint(4, 9)
        ang = np.sort(rs.rand(m) * 2 * np.pi)
        r = rs.rand(m) * 35 + 6
        polys.append([np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).reshape(-1)])
    return polys


def _slender_polys(rs, n=8, canvas=CANVAS):
    """Rotated rectangles of aspect 8-30 with a vertex repeated and a
    midpoint on an edge (collinear), integer vertices."""
    H, W = canvas
    polys = []
    for _ in range(n):
        L = rs.randint(40, 150)
        w = max(2, L // rs.randint(8, 31))
        a = rs.rand() * np.pi
        c = np.array([rs.randint(30, W - 30), rs.randint(30, H - 30)], np.float64)
        u = np.array([np.cos(a), np.sin(a)]) * L / 2
        v = np.array([-np.sin(a), np.cos(a)]) * w / 2
        corners = np.round(np.stack([c - u - v, c + u - v, c + u + v, c - u + v]))
        pts = np.concatenate([corners[:2], (corners[1:2] + corners[2:3]) / 2, corners[2:],
                              corners[3:]])
        polys.append([pts.reshape(-1)])
    return polys


POLYSETS = {
    "random": lambda rs: _random_polys(rs),
    "slender": lambda rs: _slender_polys(rs),
    # clipped by the canvas, two parts of one instance, area <= 1 (dropped)
    # and collinear (no hull)
    "edges": lambda rs: [
        [np.array([-30.0, -20.0, 60.0, -10.0, 50.0, 70.0, -25.0, 55.0])],
        [np.array([300.0, 220.0, 340.0, 230.0, 335.0, 260.0])],
        [np.array([100.0, 100.0, 140.0, 100.0, 140.0, 110.0]),
         np.array([150.0, 120.0, 160.0, 140.0, 145.0, 150.0])],
        [np.array([10.0, 200.0, 11.0, 200.0, 11.0, 201.0])],
        [np.array([20.0, 20.0, 30.0, 30.0, 40.0, 40.0])],
    ],
    "integer": lambda rs: [[rs.randint(0, 200, 2 * rs.randint(3, 12)).astype(np.float64)]
                           for _ in range(10)],
}


def _render(mod, polys, native):
    old = mod.USE_NATIVE
    mod.USE_NATIVE = native
    try:
        m = mod.BorderMasks(polys)
        return [m.center_masks(CANVAS, "gaussian", 0.5), m.center_masks(CANVAS, "linear"),
                m.center_masks(CANVAS, "gaussian", 1.5), *m.masks(CANVAS),
                *m.border_masks(CANVAS)]
    finally:
        mod.USE_NATIVE = old


@pytest.fixture(scope="module")
def natives():
    if not jnative.available():
        pytest.skip("no C compiler for the JAX package's native renderer")
    assert tnative.available() and tnative.backend() == "c"
    return True


@pytest.mark.parametrize("renderer", ["numpy", "native"])
@pytest.mark.parametrize("polyset", sorted(POLYSETS))
def test_maps_bit_equal_to_jax(natives, polyset, renderer):
    polys = POLYSETS[polyset](np.random.RandomState(sorted(POLYSETS).index(polyset)))
    native = renderer == "native"
    want = _render(jborders, polys, native)
    got = _render(tborders, polys, native)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert want[0].max() > 0.9 and want[3].max() > 0.9 and want[5].max() > 1.0


@pytest.mark.parametrize("polyset", sorted(POLYSETS))
def test_native_matches_numpy_within_tolerance(natives, polyset):
    """C against numpy in the port to ``tests/test_border_native.py``'s
    tolerances, but for one step that the reference has too: a pixel on the
    hull's boundary (integer vertices put some exactly there) gets the
    gaussian score's value at t = 1, exp(-1 / (2 sigma^2)), from one
    renderer and 0 from the other, since t lands an ulp either side of 1.
    Those pixels are the JAX package's, value for value."""
    polys = POLYSETS[polyset](np.random.RandomState(sorted(POLYSETS).index(polyset)))
    t_nat, t_ref = _render(tborders, polys, True), _render(tborders, polys, False)
    j_nat, j_ref = _render(jborders, polys, True), _render(jborders, polys, False)
    steps = {0: np.float32(np.exp(-2.0)), 2: np.float32(np.exp(-1 / 4.5))}  # sigma 0.5, 1.5
    n_steps = 0
    for i, (n, r) in enumerate(zip(t_nat, t_ref)):
        np.testing.assert_array_equal(n - r, j_nat[i] - j_ref[i])
        tol = SIZE_ATOL if i in (5, 7) else MAP_ATOL       # the size maps
        far = np.abs(n - r) > tol
        if i in steps:
            pair = np.sort(np.stack([n[far], r[far]]), axis=0)
            np.testing.assert_array_equal(pair[0], 0.0)
            np.testing.assert_array_equal(pair[1], steps[i])
            n_steps += int(far.sum())
        else:
            assert not far.any(), i
    assert n_steps <= (12 if polyset == "integer" else 0)


def test_native_library_builds_under_build(natives):
    path = tnative.library_path()
    assert path.exists() and path.parent.parent.name == "border_render"
    assert path.parents[2].name == "build"
    # never beside the source, where the JAX package's loader keeps its own
    assert not any(p.suffix == ".so" for p in tnative._SRC.parent.iterdir())


def test_native_build_failure_is_logged_and_numpy_renders(monkeypatch, tmp_path, caplog):
    """No compiler: ``available()`` is false, the failure is logged with the
    compilers' messages, and the maps are the numpy renderer's."""
    polys = POLYSETS["random"](np.random.RandomState(0))
    want = _render(tborders, polys, False)

    def no_compiler(*args, **kwargs):
        raise OSError("no such compiler")

    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "border_render")
    monkeypatch.setattr(tnative.subprocess, "run", no_compiler)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    with caplog.at_level(logging.WARNING, logger=tnative.__name__):
        assert not tnative.available() and tnative.backend() == "numpy"
    assert "no such compiler" in caplog.text and "numpy" in caplog.text
    for g, w in zip(_render(tborders, polys, True), want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ mapper
def cfg_pair(arch, **overrides):
    base = {"MODEL.META_ARCHITECTURE": arch, "NEED_MASKS": True,
            "INPUT.MIN_SIZE_TRAIN": (48, 64), "INPUT.MAX_SIZE_TRAIN": 160,
            "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 160,
            "TPU.MAX_GT_PER_IMAGE": 4, **overrides}
    out = []
    for get_cfg in (jax_get_cfg, torch_get_cfg):
        cfg = get_cfg()
        cfg.merge_from_list([x for kv in base.items() for x in kv])
        cfg.freeze()
        out.append(cfg)
    return out


def polygon_dicts(seed, n=6):
    """Inlined images of both orientations, each with 3-9 instances of
    integer-vertex polygons (slender ones among them, one of two parts),
    one crowd, one with an RLE dict for segmentation and one outside the
    image (dropped by the box filter): more instances than
    MAX_GT_PER_IMAGE, whose maps are all rendered."""
    rs = np.random.RandomState(seed)
    dicts = []
    for i in range(n):
        h, w = (96, 128) if i % 2 == 0 else (128, 96)
        annos = []
        for k in range(rs.randint(3, 10)):
            x, y = rs.randint(0, w - 12), rs.randint(0, h - 12)
            if rs.rand() < 0.5:
                bw, bh = rs.randint(30, 60), rs.randint(2, 7)
            else:
                bw, bh = rs.randint(6, 40), rs.randint(6, 40)
            bw, bh = min(bw, w - x), min(bh, h - y)
            poly = [x, y, x + bw, y + rs.randint(0, 3), x + bw, y + bh, x + rs.randint(0, 3),
                    y + bh]
            seg = [poly] if k != 2 else [poly, [x, y, x + 3, y, x, y + 3]]
            annos.append({"bbox": [float(x), float(y), float(x + bw), float(y + bh)],
                          "category_id": int(rs.randint(3)), "iscrowd": int(k == 1),
                          "segmentation": seg})
        annos.append({"bbox": [w + 4.0, 2.0, w + 9.0, 8.0], "category_id": 0, "iscrowd": 0,
                      "segmentation": [[w + 4, 2, w + 9, 2, w + 9, 8]]})
        annos.append({"bbox": [1.0, 1.0, 20.0, 20.0], "category_id": 1, "iscrowd": 0,
                      "segmentation": {"size": [h, w], "counts": "x"}})
        dicts.append({"image": rs.randint(0, 256, (h, w, 3)).astype(np.uint8),
                      "image_id": i, "height": h, "width": w, "annotations": annos})
    return dicts


MASK_KEYS = {"FCOSV3": ("center_mask",),
             "ProposalNetworkWithMasks": ("center_mask", "border_mask", "size_map")}


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("arch", sorted(MASK_KEYS))
def test_mapper_maps_bit_equal_to_jax(arch, is_train):
    jcfg, tcfg = cfg_pair(arch)
    jm, tm = jmapper.DatasetMapper(jcfg, is_train), tmapper.DatasetMapper(tcfg, is_train)
    seen = set()
    for seed, d in enumerate(polygon_dicts(31) * 2):
        want = jm(d, rng=np.random.default_rng(seed))
        got = tm(d, rng=np.random.default_rng(seed))
        assert sorted(got) == sorted(want)
        assert not {"border_mask", "size_map"} - set(MASK_KEYS[arch]) & set(got)
        for k, w in want.items():
            if k == "image_id":
                assert got[k] == w
                continue
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        for k in MASK_KEYS[arch]:
            assert got[k].shape[:2] == got["image"].shape[:2]
        assert got["center_mask"].max() > 0.9
        r = np.random.default_rng(seed)       # the mapper's two draws
        tT.choose_train_size(r, tm.min_sizes, tm.sampling)
        seen.add((got["image"].shape[:2], is_train and r.random() < 0.5))
    shapes = {s for s, _ in seen}
    assert len(shapes) == 2                       # both buckets
    if is_train:
        assert {True, False} <= {f for _, f in seen}


def test_mapper_maps_without_cv2_stay_bit_equal(monkeypatch):
    """With cv2 gone the image is resized on torch, but the maps are
    rendered from the scaled polygons at the same size: bit-equal."""
    jcfg, tcfg = cfg_pair("ProposalNetworkWithMasks")
    jm, tm = jmapper.DatasetMapper(jcfg, True), tmapper.DatasetMapper(tcfg, True)
    dicts = polygon_dicts(32, n=4)
    want = [jm(d, rng=np.random.default_rng(i)) for i, d in enumerate(dicts)]
    monkeypatch.setattr(tT, "cv2", None)
    monkeypatch.setattr(tmapper, "cv2", None)
    resized = 0
    for i, d in enumerate(dicts):
        got = tm(d, rng=np.random.default_rng(i))
        resized += float(got["scale"]) != 1.0
        for k in MASK_KEYS["ProposalNetworkWithMasks"]:
            np.testing.assert_array_equal(got[k], want[i][k], err_msg=k)
    assert resized == len(dicts)
