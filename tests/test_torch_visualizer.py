"""The port's cv2-free drawing held pixel-equal to cv2 5.0 and to the JAX
package's visualizer and drawing tools on the CPU.

- ``utils/draw.py``'s primitives against cv2 on seeded and hypothesis-drawn
  shapes, shapes clipped at the image border included: lines, rectangles,
  polylines (thickness 1, and 2-5 with their fixed-point convex fill),
  filled circles, the weighted blend, the ``INTER_LINEAR`` resize
  and ``boxPoints`` bit for bit; filled polygons bit for bit inside the
  image and where its border clips them.
- The glyph table: printable ASCII at 0.35 and 1.0, each glyph and whole
  lines, pixel-equal to ``cv2.putText``.
- ``utils/visualizer.py`` against ``slenderobjdet_tpu/utils/visualizer.py``
  method by method; ``utils/png.py`` and ``utils/webcv2.py`` (the PNG read
  back over HTTP on localhost).
- The map tools' outputs equal to the JAX tools', and each visualize script
  once against its JAX counterpart run in this process, whose
  ``cv2.imwrite`` is caught so that its image is compared before JPEG.

Every input comes from a seed here or from hypothesis.
"""

import importlib.util
import json
import os
import sys
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.tools import (generate_border_maps, mask_to_rbox,  # noqa: E402
                                       visualize_anchors, visualize_data,
                                       visualize_dataloader, visualize_json_results,
                                       visualize_proposals, visualize_slender_results,
                                       visulize_iou)
from slenderobjdet_torch.utils import draw, png, webcv2  # noqa: E402
from slenderobjdet_torch.utils import visualizer as tvis  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402
from slenderobjdet_tpu.utils import visualizer as jvis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FONT = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = "".join(chr(c) for c in range(32, 127))
HYPO = settings(max_examples=60, deadline=None, derandomize=True,
                suppress_health_check=[HealthCheck.too_slow])
NAME = "torch_visualizer_synth"


def canvas(rs, h, w):
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def color(rs):
    return tuple(int(v) for v in rs.randint(0, 256, 3))


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("seed", range(4))
def test_primitives_equal_cv2_on_seeded_shapes(seed):
    rs = np.random.RandomState(100 + seed)
    for _ in range(100):
        h, w = rs.randint(5, 70, 2)
        img, col = canvas(rs, h, w), color(rs)
        p1, p2 = (tuple(int(v) for v in rs.randint(-30, 100, 2)) for _ in range(2))
        for ours, theirs in ((draw.line, cv2.line), (draw.rectangle, cv2.rectangle)):
            a, b = img.copy(), img.copy()
            theirs(a, p1, p2, col, 1)
            np.testing.assert_array_equal(ours(b, p1, p2, col), a)
        pts = [rs.randint(-30, 100, (rs.randint(2, 8), 2)).astype(np.int32)
               for _ in range(rs.randint(1, 3))]
        closed = bool(rs.randint(2))
        a = cv2.polylines(img.copy(), pts, closed, col, 1)
        np.testing.assert_array_equal(draw.polylines(img.copy(), pts, closed, col), a)
        c, r = tuple(int(v) for v in rs.randint(-20, 90, 2)), int(rs.randint(0, 30))
        a = cv2.circle(img.copy(), c, r, col, -1)
        np.testing.assert_array_equal(draw.circle_filled(img.copy(), c, r, col), a)
        other, alpha = canvas(rs, h, w), float(rs.rand())
        np.testing.assert_array_equal(draw.add_weighted(img, alpha, other, 1 - alpha, 0),
                                      cv2.addWeighted(img, alpha, other, 1 - alpha, 0))
        size = (int(rs.randint(1, 150)), int(rs.randint(1, 150)))
        np.testing.assert_array_equal(draw.resize_linear(img, size), cv2.resize(img, size))
        box = ((float(rs.uniform(-50, 500)), float(rs.uniform(-50, 500))),
               (float(rs.uniform(0, 300)), float(rs.uniform(0, 300))), float(rs.uniform(-180, 180)))
        np.testing.assert_array_equal(draw.box_points(*box), cv2.boxPoints(box))


def test_resize_equals_cv2_on_channel_counts_and_halving():
    rs = np.random.RandomState(7)
    for shape in [(31, 47), (31, 47, 1), (31, 47, 3), (31, 47, 4), (40, 64, 3)]:
        img = rs.randint(0, 256, shape).astype(np.uint8)
        for size in [(23, 15), (94, 62), (47, 31), (32, 20), (1, 1), (200, 3)]:
            np.testing.assert_array_equal(draw.resize_linear(img, size), cv2.resize(img, size))


def _fill_pair(h, w, polys, col=(255, 255, 255)):
    a = np.zeros((h, w, 3), np.uint8)
    cv2.fillPoly(a, polys, col)
    return a, draw.fill_poly(np.zeros((h, w, 3), np.uint8), polys, col)


@pytest.mark.parametrize("seed", range(2))
def test_fill_poly_equals_cv2_inside_and_is_bounded_where_clipped(seed):
    """Bit for bit, inside the image and where its border clips a polygon
    (the bound on a clipped case is now zero pixels). A clipped edge takes
    the clipped x's always and the clipped y's only where they differ; an
    edge clipped to one point of a border column runs straight down it."""
    rs = np.random.RandomState(200 + seed)
    clipped = 0
    for _ in range(300):
        h, w = rs.randint(5, 80, 2)
        inside = bool(rs.randint(2))
        lo, hi = ((0, 0), (w, h)) if inside else ((-40, -40), (w + 40, h + 40))
        polys = [np.stack([rs.randint(lo[0], hi[0], n), rs.randint(lo[1], hi[1], n)], 1)
                 .astype(np.int32) for n in rs.randint(3, 9, rs.randint(1, 4))]
        a, b = _fill_pair(h, w, polys)
        np.testing.assert_array_equal(b, a)
        clipped += not inside
    assert clipped > 100


@pytest.mark.parametrize("poly", [
    [[28, -16], [3, 36], [-14, 12], [40, 69], [1, 42], [-25, 24]],
    [[-3, 3], [0, -3], [0, 0]],               # an edge clipped to the point (0, 0)
    [[40, 3], [31, 9], [35, 20]],             # the same at the right border
    [[-5000, -7000], [9000, 12], [-3, 6000]],
])
def test_fill_poly_clipped_edges_equal_cv2(poly):
    a, b = _fill_pair(32, 32, [np.array(poly, np.int32)], (9, 140, 250))
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
def test_thick_lines_rectangles_polylines_equal_cv2(thickness):
    """``LINE_8`` at thickness 2-5 bit for bit: segments, rectangles and
    closed and open polylines, inside the image, clipped by its border and
    far outside it, degenerate segments among them."""
    rs = np.random.RandomState(300 + thickness)
    col = (3, 200, 91)
    for case in range(150):
        h, w = rs.randint(5, 60, 2)
        margin = (0, 30, 300)[case % 3]
        lo, hi = (-margin, -margin), (w + margin, h + margin)
        p, q = [(int(rs.randint(lo[0], hi[0])), int(rs.randint(lo[1], hi[1]))) for _ in range(2)]
        if case % 25 == 0:
            q = p
        img = np.full((h, w, 3), 17, np.uint8)
        np.testing.assert_array_equal(draw.line(img.copy(), p, q, col, thickness),
                                      cv2.line(img.copy(), p, q, col, thickness))
        np.testing.assert_array_equal(draw.rectangle(img.copy(), p, q, col, thickness),
                                      cv2.rectangle(img.copy(), p, q, col, thickness))
        pts = np.stack([rs.randint(lo[0], hi[0], 4), rs.randint(lo[1], hi[1], 4)], 1)
        for closed in (True, False):
            np.testing.assert_array_equal(
                draw.polylines(img.copy(), [pts], closed, col, thickness),
                cv2.polylines(img.copy(), [pts.astype(np.int32)], closed, col, thickness))


def test_fixed_point_fill_convex_poly_equals_cv2():
    """The thick line's quadrilateral fill (``FillConvexPoly`` with 16 bits
    of fraction and OpenCV 5.0's ``Line2`` outline) against
    ``cv2.fillConvexPoly(..., shift=16)`` on seeded rotated rectangles,
    inside and clipped."""
    rs = np.random.RandomState(14)
    for _ in range(400):
        h, w = rs.randint(4, 24, 2)
        c = rs.uniform(-10, w + 10), rs.uniform(-10, h + 10)
        a, length, half = rs.uniform(0, np.pi), rs.uniform(0, 12), rs.uniform(0.5, 4)
        d = np.array([np.cos(a), np.sin(a)]) * length
        e = np.array([-np.sin(a), np.cos(a)]) * half
        pts = [(int(x * 65536), int(y * 65536)) for x, y in (c + d + e, c + d - e, c - d - e,
                                                              c - d + e)]
        img = np.zeros((h, w), np.uint8)
        want = cv2.fillConvexPoly(img.copy(), np.array(pts, np.int32), 255, cv2.LINE_8, 16)
        got = img.copy()
        draw._fill_convex_poly(got, pts, 255)
        np.testing.assert_array_equal(got, want)


@HYPO
@given(st.integers(4, 60), st.integers(4, 60), st.lists(st.integers(-40, 100), min_size=4,
       max_size=4), st.integers(0, 40))
def test_hypothesis_lines_rectangles_circles(h, w, c, r):
    img = np.full((h, w, 3), 17, np.uint8)
    col = (3, 200, 91)
    for ours, theirs in ((draw.line, cv2.line), (draw.rectangle, cv2.rectangle)):
        a = theirs(img.copy(), (c[0], c[1]), (c[2], c[3]), col, 1)
        np.testing.assert_array_equal(ours(img.copy(), (c[0], c[1]), (c[2], c[3]), col), a)
    a = cv2.circle(img.copy(), (c[0], c[1]), r, col, -1)
    np.testing.assert_array_equal(draw.circle_filled(img.copy(), (c[0], c[1]), r, col), a)


@HYPO
@given(st.integers(4, 60), st.integers(4, 60), st.lists(st.integers(-80, 140), min_size=4,
       max_size=4), st.integers(2, 9))
def test_hypothesis_thick_lines_and_rectangles(h, w, c, thickness):
    img = np.full((h, w, 3), 17, np.uint8)
    col = (3, 200, 91)
    for ours, theirs in ((draw.line, cv2.line), (draw.rectangle, cv2.rectangle)):
        a = theirs(img.copy(), (c[0], c[1]), (c[2], c[3]), col, thickness)
        np.testing.assert_array_equal(
            ours(img.copy(), (c[0], c[1]), (c[2], c[3]), col, thickness), a)


@HYPO
@given(st.integers(4, 60), st.integers(4, 60),
       st.lists(st.tuples(st.integers(0, 59), st.integers(0, 59)), min_size=3, max_size=9))
def test_hypothesis_fill_poly_inside(h, w, pts):
    poly = np.array([(min(x, w - 1), min(y, h - 1)) for x, y in pts], np.int32)
    a, b = _fill_pair(h, w, [poly], (9, 140, 250))
    np.testing.assert_array_equal(b, a)


@HYPO
@given(st.integers(4, 60), st.integers(4, 60),
       st.lists(st.lists(st.tuples(st.integers(-70, 130), st.integers(-70, 130)), min_size=3,
                         max_size=9), min_size=1, max_size=3))
def test_hypothesis_fill_poly_clipped(h, w, polys):
    a, b = _fill_pair(h, w, [np.array(p, np.int32) for p in polys], (9, 140, 250))
    np.testing.assert_array_equal(b, a)


@HYPO
@given(st.text(st.characters(min_codepoint=32, max_codepoint=126), min_size=1, max_size=24),
       st.integers(-40, 140), st.integers(-10, 60), st.sampled_from([0.35, 1.0]))
def test_hypothesis_text_equals_put_text(text, x, y, scale):
    rs = np.random.RandomState(len(text) + x + 40)
    img, col = canvas(rs, 48, 120), color(rs)
    a = cv2.putText(img.copy(), text, (x, y), FONT, scale, col, 1)
    np.testing.assert_array_equal(draw.put_text(img.copy(), text, (x, y), scale, col), a)


@pytest.mark.parametrize("scale", [0.35, 1.0])
def test_glyph_table_renders_printable_ascii_like_cv2(scale):
    """Every glyph alone, and printable ASCII as lines of 19, on black and on
    a seeded background: no glyph differs by a pixel."""
    rs = np.random.RandomState(int(scale * 100))
    for ch in PRINTABLE:
        a = cv2.putText(np.zeros((60, 60, 3), np.uint8), ch, (10, 40), FONT, scale,
                        (255, 255, 255), 1)
        b = draw.put_text(np.zeros((60, 60, 3), np.uint8), ch, (10, 40), scale, (255, 255, 255))
        assert np.array_equal(a, b), repr(ch)
    for i in range(0, len(PRINTABLE), 19):
        img, col = canvas(rs, 60, 600), color(rs)
        line = PRINTABLE[i:i + 19]
        a = cv2.putText(img.copy(), line, (5, 40), FONT, scale, col, 1)
        np.testing.assert_array_equal(draw.put_text(img.copy(), line, (5, 40), scale, col), a)
    with pytest.raises(ValueError):
        draw.put_text(np.zeros((9, 9, 3), np.uint8), "é", (0, 8), scale, (1, 2, 3))


# ------------------------------------------------------------- visualizer
def _pair(img, names=None):
    return jvis.Visualizer(img, class_names=names), tvis.Visualizer(img, class_names=names)


def test_visualizer_methods_equal_the_jax_visualizer():
    rs = np.random.RandomState(11)
    img = canvas(rs, 90, 140)
    xy = rs.uniform(-10, 130, (12, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(2, 60, (12, 2))], 1)
    scores, classes = rs.rand(12), rs.randint(0, 5, 12)
    names = ["person", "kite", "ski", "bat", "pole"]
    for kwargs in ({}, {"scores": scores}, {"classes": classes},
                   {"scores": scores, "classes": classes, "color_by_ratio": False}):
        for class_names in (None, names):
            j, t = _pair(img, class_names)
            np.testing.assert_array_equal(t.draw_boxes(boxes, **kwargs),
                                          j.draw_boxes(boxes, **kwargs))
    j, t = _pair(img)
    rboxes = np.concatenate([rs.uniform(0, 140, (10, 2)), rs.uniform(2, 80, (10, 2)),
                             rs.uniform(-90, 90, (10, 1))], 1)
    np.testing.assert_array_equal(t.draw_rotated_boxes(rboxes), j.draw_rotated_boxes(rboxes))
    np.testing.assert_array_equal(t.draw_proposals(boxes, max_n=8), j.draw_proposals(boxes, max_n=8))
    np.testing.assert_array_equal(t.draw_anchors(boxes), j.draw_anchors(boxes))
    for thickness in (2, 3, 4, 5):          # cv2's thick lines, boxes clipped by the border
        j, t = _pair(img, names)
        np.testing.assert_array_equal(
            t.draw_boxes(boxes, scores, classes, thickness=thickness),
            j.draw_boxes(boxes, scores, classes, thickness=thickness))
        np.testing.assert_array_equal(t.draw_rotated_boxes(rboxes, thickness=thickness),
                                      j.draw_rotated_boxes(rboxes, thickness=thickness))


def test_draw_instances_equals_the_jax_visualizer():
    rs = np.random.RandomState(12)
    img = canvas(rs, 100, 160)
    masks, boxes = [], []
    for _ in range(6):
        x0, y0 = rs.uniform(0, 100), rs.uniform(0, 60)
        pts = np.stack([x0 + rs.uniform(0, 55, 6), y0 + rs.uniform(0, 35, 6)], 1)
        masks.append([pts.reshape(-1).tolist()] if rs.rand() < 0.5 else [pts])
        boxes.append([pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()])
    boxes = np.array(boxes)
    for kwargs in ({"boxes": boxes, "masks": masks, "scores": rs.rand(6), "classes": [1] * 6},
                   {"masks": masks, "alpha": 0.7}, {"boxes": boxes, "color_by_ratio": False}):
        j, t = _pair(img, ["a", "b"])
        np.testing.assert_array_equal(t.draw_instances(**kwargs), j.draw_instances(**kwargs))


def test_group_by_ratio_group_and_smart_concatenate_equal_the_jax_ones():
    rs = np.random.RandomState(13)
    vals = rs.uniform(0, 8, 40).tolist()
    ranges = {"slender": [(0.0, 1 / 3), (3.0, 1e5)], "normal": (1 / 3, 3.0), "all": (0.0, 1e5)}
    assert tvis.group_by(list(range(40)), vals, ranges) == jvis.group_by(list(range(40)), vals,
                                                                         ranges)
    for w, h in rs.uniform(0.1, 50, (50, 2)):
        assert tvis.ratio_group(w, h) == jvis.ratio_group(w, h)
    imgs = [canvas(rs, 33, 45) for _ in range(5)]
    for kwargs in ({}, {"num_rows": 1}, {"num_columns": 2}, {"out_shape": (70, 101)}):
        np.testing.assert_array_equal(tvis.smart_concatenate(imgs, **kwargs),
                                      jvis.smart_concatenate(imgs, **kwargs))


# ------------------------------------------------------------ PNG, webcv2
def test_png_round_trips_through_cv2():
    rs = np.random.RandomState(14)
    for shape in [(17, 23, 3), (5, 9), (8, 7, 4), (40, 60, 3)]:
        img = rs.randint(0, 256, shape).astype(np.uint8)
        img[: shape[0] // 2] //= 32                       # rows cv2 filters otherwise
        data = png.encode(img)
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(png.decode(data), img)
        ok, enc = cv2.imencode(".png", img)
        np.testing.assert_array_equal(png.decode(enc.tobytes()), img)


def test_webcv2_serves_the_png_on_localhost():
    img = np.random.RandomState(15).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    try:
        webcv2.imshow("panel", img, port=0, host="127.0.0.1")
        host, port = webcv2.address()
        with urllib.request.urlopen(f"http://{host}:{port}/img/panel", timeout=10) as r:
            assert r.headers["Content-Type"] == "image/png"
            np.testing.assert_array_equal(png.decode(r.read()), img)
        with urllib.request.urlopen(f"http://{host}:{port}/", timeout=10) as r:
            assert b'src="/img/panel"' in r.read()
        assert webcv2.waitKey(1) == -1
    finally:
        webcv2.shutdown()


# ------------------------------------------------------------------ tools
def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(monkeypatch, name, argv):
    """The JAX tool's ``main`` on ``argv`` in this process, its
    ``cv2.imwrite`` caught: {file name: image}."""
    mod = jax_tool(name)
    written = {}

    def imwrite(path, img):
        written[os.path.splitext(os.path.basename(path))[0]] = np.array(img)
        return True

    if hasattr(mod, "cv2"):
        monkeypatch.setattr(mod.cv2, "imwrite", imwrite)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod.main()
    return written


def port_images(paths):
    return {os.path.splitext(os.path.basename(p))[0]: png.imread(p) for p in paths}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_visualizer")
    path, root = make_coco_json(tmp, num_images=4, img_hw=(64, 96), slender=True, seed=3)
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    with open(path) as f:
        data = json.load(f)
    rs = np.random.RandomState(16)
    results = [{"image_id": a["image_id"], "category_id": a["category_id"], "score": float(s),
                "bbox": [v + float(d) for v, d in zip(a["bbox"], rs.uniform(-3, 3, 4))]}
               for a, s in zip(data["annotations"], rs.uniform(0.2, 1.0, len(data["annotations"])))]
    res = tmp / "results.json"
    res.write_text(json.dumps(results))
    boxes = [np.array([a["bbox"] for a in data["annotations"] if a["image_id"] == i], np.float32)
             for i in range(1, 5)]
    props = {"ids": [1, 2, 3, 4], "bbox_mode": "XYXY_ABS",
             "boxes": [np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], 1) for b in boxes],
             "anchors": [np.concatenate([b[:, :2] - 2, b[:, :2] + b[:, 2:] + 2], 1) for b in boxes],
             "objectness_logits": [rs.uniform(-1, 3, len(b)).astype(np.float32) for b in boxes]}
    pkl = tmp / "box_proposals.pkl"
    import pickle
    pkl.write_bytes(pickle.dumps(props))
    yaml = tmp / "cfg.yaml"
    from slenderobjdet_torch.config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list(["DATASETS.TRAIN", (NAME,), "DATASETS.TEST", (NAME,),
                         "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 128,
                         "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 128,
                         "SOLVER.IMS_PER_BATCH", 2, "DATALOADER.NUM_WORKERS", 0])
    yaml.write_text(cfg.dump())
    return {"tmp": tmp, "json": path, "root": root, "results": str(res), "pkl": str(pkl),
            "yaml": str(yaml)}


def test_map_tools_equal_the_jax_tools(synth, monkeypatch):
    tmp = synth["tmp"]
    run_jax_tool(monkeypatch, "mask_to_rbox", ["--gt-json", synth["json"], "--out",
                                               str(tmp / "jax_rcoco.json")])
    mask_to_rbox.main(["--gt-json", synth["json"], "--out", str(tmp / "rcoco.json")])
    assert json.loads((tmp / "rcoco.json").read_text()) == json.loads(
        (tmp / "jax_rcoco.json").read_text())
    run_jax_tool(monkeypatch, "generate_border_maps", ["--gt-json", synth["json"],
                                                       "--out-dir", str(tmp / "jax_maps")])
    assert generate_border_maps.main(["--gt-json", synth["json"],
                                      "--out-dir", str(tmp / "maps")]) == 4
    assert sorted(os.listdir(tmp / "maps")) == sorted(os.listdir(tmp / "jax_maps"))
    for f in os.listdir(tmp / "maps"):
        with np.load(tmp / "maps" / f) as got, np.load(tmp / "jax_maps" / f) as want:
            assert sorted(got.files) == sorted(want.files) == ["border", "center", "sizes"]
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f} {k}")


def assert_same_images(got, want):
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_result_scripts_equal_the_jax_scripts(synth, monkeypatch):
    """visualize_json_results, visualize_proposals and
    visualize_slender_results: each panel pixel-equal."""
    tmp, common = synth["tmp"], ["--gt-json", synth["json"], "--image-root", synth["root"]]
    argv = ["--result", synth["results"], *common, "--conf-threshold", "0.3"]
    want = run_jax_tool(monkeypatch, "visualize_json_results", argv + ["--output", "x"])
    assert_same_images(port_images(visualize_json_results.main(
        argv + ["--output", str(tmp / "vj")])), want)
    argv = ["--proposal", synth["pkl"], "--result", synth["results"], *common,
            "--proposal-threshold", "0.6"]
    want = run_jax_tool(monkeypatch, "visualize_proposals", argv + ["--output", "x"])
    assert_same_images(port_images(visualize_proposals.main(
        argv + ["--output", str(tmp / "vp")])), want)
    argv = ["--results", synth["results"], *common, "--score-thresh", "0.1"]
    want = run_jax_tool(monkeypatch, "visualize_slender_results", argv + ["--out-dir", "x"])
    assert any(k.endswith("_gt") for k in want)
    assert_same_images(port_images(visualize_slender_results.main(
        argv + ["--out-dir", str(tmp / "vs")])), want)


def test_loader_scripts_equal_the_jax_scripts(synth, monkeypatch):
    """visualize_anchors (grid and saved proposals), visualize_dataloader and
    visualize_data (annotations and loader): each image pixel-equal."""
    tmp, yaml = synth["tmp"], synth["yaml"]
    for extra in ([], ["--proposals-pkl", synth["pkl"]]):
        argv = ["--config-file", yaml, "--num-images", "3", *extra]
        want = run_jax_tool(monkeypatch, "visualize_anchors", argv + ["--out-dir", "x"])
        assert_same_images(port_images(visualize_anchors.main(
            argv + ["--out-dir", str(tmp / f"va{len(extra)}")])), want)
    argv = ["--config-file", yaml, "--num-batches", "2"]
    want = run_jax_tool(monkeypatch, "visualize_dataloader", argv + ["--out-dir", "x"])
    assert_same_images(port_images(visualize_dataloader.main(
        argv + ["--out-dir", str(tmp / "vd")])), want)
    common = ["--gt-json", synth["json"], "--image-root", synth["root"]]
    want = run_jax_tool(monkeypatch, "visualize_data", ["--source", "annotation", *common,
                                                        "--output-dir", "x"])
    got = visualize_data.main(["--source", "annotation", *common,
                               "--output-dir", str(tmp / "vdata")])
    assert got["all"] == 10 and got["written"] == 4
    assert_same_images(port_images(sorted(str(p) for p in (tmp / "vdata").iterdir())), want)


def test_visulize_iou_curves_equal_the_jax_tool(monkeypatch, tmp_path):
    """The plotted values, caught from the JAX tool's matplotlib axes."""
    mod = jax_tool("visulize_iou")
    for b1, b2, dist in visulize_iou.CASES:
        plotted = []

        class Axes:
            def __getattr__(self, name):
                return lambda *a, **k: (plotted.append(a) if name == "plot" else Axes())

        monkeypatch.setattr(mod.plt, "subplots", lambda: (None, Axes()))
        mod.vis_boxes(b1.copy(), b2.copy(), distance=getattr(mod, dist.__name__))
        xs, ious, losses, outlined = visulize_iou.curves(b1, b2, distance=dist)
        np.testing.assert_array_equal(xs, plotted[0][0])
        np.testing.assert_array_equal(ious, plotted[0][1])
        np.testing.assert_array_equal(losses, plotted[1][1])
        assert len(outlined) == 4
    paths = visulize_iou.main(["--out-dir", str(tmp_path)])
    assert [png.imread(p).shape for p in paths] == [(480, 640, 3)] * 2
