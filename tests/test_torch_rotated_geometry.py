"""The port's host rotated-box geometry without cv2, held against cv2 5.0
and the JAX package (which calls cv2) on the CPU:

- ``structures/rotated_rect.py:min_area_rect`` equals ``cv2.minAreaRect``
  bit for bit, centre, size and angle, on 5,500 point sets: the eight kinds
  of ``tests/test_torch_borders.py`` (clouds, grids with collinear runs and
  duplicates, points on a line and near it, 1 or 2 distinct points, ordered
  polygons, slender clouds, repeated vertices), rotated slender rectangles,
  squares at any angle (where the angle choice is ambiguous) and collinear
  runs with duplicates; and ``structures/masks.py``'s ``ratio_of_polygon``
  and ``rbox_from_polygon``, which now use it, equal the JAX package's
  (tolerance (cx, cy, w, h) 1e-4 absolute and angle 1e-4 degrees; every set
  here is equal);
- ``rectangle_intersection`` equals ``cv2.rotatedRectangleIntersection``
  (return code and vertices) and ``evaluation/rotated_evaluation.py:
  rotated_iou_np`` the JAX package's (cv2) within 1e-5, crowd denominators
  included, on 5,600 pairs: overlapping, nested, identical, touching at an
  edge, touching at a corner, disjoint and thin slivers;
- ``RotatedCOCOEvaluator.evaluate()`` returns the JAX evaluator's AP dict on
  the same synthetic results.

Every input comes from a numpy generator seeded in its test.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from slenderobjdet_torch.data import catalog as tcatalog
from slenderobjdet_torch.evaluation import rotated_evaluation as treval
from slenderobjdet_torch.structures import masks as tmasks
from slenderobjdet_torch.structures import rotated_rect as trect
from slenderobjdet_tpu.data import catalog as jcatalog
from slenderobjdet_tpu.evaluation import rotated_evaluation as jreval
from slenderobjdet_tpu.structures import masks as jmasks
from test_torch_borders import _cloud

RECT_ATOL = 1e-4         # (cx, cy, w, h), pixels
ANGLE_ATOL = 1e-4        # degrees
IOU_ATOL = 1e-5
BORDER_KINDS = ["cloud", "grid", "line", "near_line", "few", "polygon", "slender", "repeated"]
KINDS = BORDER_KINDS + ["rotated_slender_rect", "square", "collinear"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: under the tier's six
    workers on one shared CPU, eight threads a process make the port's many
    small operations (the plain clip, the NMS loop) wait on each other
    (``tests/test_torch_proposal.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(rs, kind):
    if kind in BORDER_KINDS:
        return _cloud(rs, kind)
    if kind == "rotated_slender_rect":              # aspect 5-200, any angle
        c, a = rs.rand(2) * 600, rs.rand() * np.pi
        w, h = rs.rand() * 300 + 10, rs.rand() * 8 + 0.5
        corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        return np.round(corners @ rot.T + c, rs.randint(0, 4))
    if kind == "square":                            # at 0, 30, 45, ... or any angle
        c, s = rs.rand(2) * 300, rs.rand() * 60 + 1
        a = np.deg2rad(rs.choice([0.0, 30.0, 45.0, 60.0, 90.0, 135.0, rs.rand() * 180]))
        corners = np.array([[-s, -s], [s, -s], [s, s], [-s, s]]) / 2
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        pts = corners @ rot.T + c
        return np.round(pts) if rs.rand() < 0.3 else pts
    # "collinear": a run along an integer direction with duplicates, an
    # off-line point in half of the sets
    m = rs.randint(2, 20)
    start, step = rs.randint(0, 100, 2), rs.randint(-6, 7, 2)
    pts = start + rs.randint(0, 10, m)[:, None] * step
    if rs.rand() < 0.5:
        pts = np.concatenate([pts, pts[:1] + [1, -2]])
    return pts.astype(np.float64)


def _flat(pts):
    return [np.asarray(pts, np.float64).reshape(-1)]


@pytest.mark.parametrize("kind", KINDS)
def test_min_area_rect_equals_cv2_and_the_jax_masks(kind):
    rs = np.random.RandomState(100 + KINDS.index(kind))
    n_rects = 0
    for _ in range(500):
        pts = _points(rs, kind)
        f32 = pts.astype(np.float32)
        want = cv2.minAreaRect(f32)
        got = trect.min_area_rect(f32)
        assert got == want, (kind, pts.tolist())
        n_rects += want[1][0] * want[1][1] > 0
        polys = _flat(pts)
        if pts.shape[0] >= 3:
            assert tmasks.ratio_of_polygon(polys) == jmasks.ratio_of_polygon(polys)
            g, w = tmasks.rbox_from_polygon(polys), jmasks.rbox_from_polygon(polys)
            np.testing.assert_allclose(g[:4], w[:4], rtol=0, atol=RECT_ATOL)
            assert abs(g[4] - w[4]) <= ANGLE_ATOL
            assert g == w
    if kind in ("line", "few"):
        assert n_rects == 0
    elif kind == "near_line":            # float32 rounding leaves thin hulls
        assert n_rects > 100
    elif kind != "collinear":
        assert n_rects > 400


def test_rbox_of_a_turned_slender_rectangle():
    """A 100 x 8 rectangle turned by 30 degrees gives back (cx, cy, 100, 8,
    30) up to float32, with the angle in (-45, 45]."""
    t = np.deg2rad(30.0)
    u, v = np.array([np.cos(t), np.sin(t)]), np.array([-np.sin(t), np.cos(t)])
    pts = np.array([200 + a * 50 * u + b * 4 * v for a, b in ((-1, -1), (1, -1), (1, 1),
                                                                 (-1, 1))])
    cx, cy, w, h, angle = tmasks.rbox_from_polygon(_flat(pts))
    assert [cx, cy, w, h] == pytest.approx([200, 200, 100, 8], abs=1e-3)
    assert -45 < angle <= 45 and abs(abs(angle) - 30) < 1e-3
    assert [cx, cy, w, h, angle] == jmasks.rbox_from_polygon(_flat(pts))


# ------------------------------------------------------------ rotated IoU
PAIR_KINDS = ["overlapping", "nested", "identical", "edge", "corner", "disjoint", "sliver"]


def _rboxes(rs, n, span):
    return np.stack([rs.rand(n) * span, rs.rand(n) * span, rs.rand(n) * 150 + 1,
                     rs.rand(n) * 60 + 1, rs.rand(n) * 180 - 90], 1)


def _pairs(rs, kind, n=40, g=20):
    dt = _rboxes(rs, n, 60 if kind == "overlapping" else 500)
    gt = _rboxes(rs, g, 60 if kind == "overlapping" else 500)
    if kind in ("nested", "identical", "edge", "corner", "sliver"):
        gt = dt[rs.randint(0, n, g)].copy()
        if kind == "nested":
            gt[:, 2:4] *= rs.uniform(0.2, 0.9, (g, 2))
        elif kind in ("edge", "corner", "sliver"):
            # a copy of a detection moved by its own width (and height): the
            # two share an edge (a corner), or overlap by a 0.1% sliver
            gt[:, :4] = np.round(gt[:, :4])
            gt[:, 4] = 0.0
            src = gt.copy()
            gt[:, 0] += gt[:, 2] * (0.999 if kind == "sliver" else 1.0)
            if kind == "corner":
                gt[:, 1] += gt[:, 3]
            dt[:g] = src
    elif kind == "disjoint":
        gt[:, :2] += 2000
    return dt, gt


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_rotated_iou_equals_cv2(kind):
    """800 pairs a kind; a fifth of the gt are crowd (the detection's area
    is the denominator). The vertices of every intersection equal cv2's."""
    rs = np.random.RandomState(200 + PAIR_KINDS.index(kind))
    dt, gt = _pairs(rs, kind)
    crowd = rs.rand(len(gt)) < 0.2
    got = treval.rotated_iou_np(dt, gt, crowd)
    want = jreval.rotated_iou_np(dt, gt, crowd)
    assert got.shape == want.shape == (40, 20) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    for i in range(0, 40, 3):
        for j in range(20):
            r1 = ((dt[i, 0], dt[i, 1]), (dt[i, 2], dt[i, 3]), -dt[i, 4])
            r2 = ((gt[j, 0], gt[j, 1]), (gt[j, 2], gt[j, 3]), -gt[j, 4])
            ret, pts = cv2.rotatedRectangleIntersection(r1, r2)
            mine_ret, mine = trect.rectangle_intersection(r1, r2)
            assert mine_ret == ret
            if ret:
                np.testing.assert_array_equal(mine, pts.reshape(-1, 2))
    if kind == "disjoint":
        assert (want == 0).all()
    elif kind == "identical":
        assert np.isclose(want, 1.0, atol=1e-5).sum() >= 20
    else:
        assert (want > 0).sum() >= 5


# --------------------------------------------------------------- evaluator
NAME = "torch_rcoco_eval_synth"


def test_rotated_evaluator_ap_equals_the_jax_evaluator(tmp_path):
    """Six images of rotated gt (rboxes in the json, crowd and not, two
    classes), detections drawn near them and at random: the AP dicts of the
    two evaluators are equal, key for key."""
    rs = np.random.RandomState(300)
    images, anns, dets = [], [], []
    for i in range(1, 7):
        images.append({"id": i, "file_name": f"{i}.png", "height": 400, "width": 500})
        for k in range(rs.randint(3, 8)):
            rb = [float(v) for v in _rboxes(rs, 1, 400)[0]]
            x, y = rb[0] - rb[2] / 2, rb[1] - rb[3] / 2
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1 + k % 2,
                         "bbox": [x, y, rb[2], rb[3]], "rbox": rb, "area": rb[2] * rb[3],
                         "iscrowd": int(rs.rand() < 0.1)})
            for _ in range(2):
                jit = np.array(rb) + np.concatenate([rs.randn(4) * 3, rs.randn(1) * 5])
                dets.append((i, k % 2, jit, rs.rand()))
        for _ in range(5):
            dets.append((i, rs.randint(0, 2), _rboxes(rs, 1, 400)[0], rs.rand() * 0.5))
    path = tmp_path / "rcoco.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    batch = {"image_id": [i for i in range(1, 7)]}
    boxes = np.zeros((6, 40, 5), np.float32)
    scores = np.zeros((6, 40), np.float32)
    classes = np.zeros((6, 40), np.int32)
    valid = np.zeros((6, 40), bool)
    slot = np.zeros(6, int)
    for i, c, b, s in dets:
        r, k = i - 1, slot[i - 1]
        boxes[r, k], scores[r, k], classes[r, k], valid[r, k] = b, s, c, True
        slot[r] += 1
    outputs = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
    results = []
    for catalog, mod in ((jcatalog, jreval), (tcatalog, treval)):
        catalog.DatasetCatalog.remove(NAME)
        catalog.DatasetCatalog.register(NAME, list)
        catalog.MetadataCatalog.get(NAME).set(json_file=str(path), evaluator_type="rcoco")
        ev = mod.RotatedCOCOEvaluator(NAME)
        ev.process(batch, outputs)
        results.append(ev.evaluate())
    want, got = results
    assert list(got) == list(want) == ["bbox"]
    assert got["bbox"] == want["bbox"]
    assert 10 < got["bbox"]["AP"] < 100
    with pytest.raises(ValueError, match="rcoco"):
        ev.process(batch, {**outputs, "boxes": boxes[..., :4]})
