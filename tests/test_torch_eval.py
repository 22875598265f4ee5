"""The PyTorch port's evaluation layer held against the JAX package's on the
CPU: the slenderness geometry (``structures/masks.py``), the COCO api, the
numpy box math the evaluator uses, the ratio-bucketed COCOeval with its C
matcher and its numpy path, the AR matrix, ``COCOEvaluator`` on fixed
predictions (``bbox`` and ``ar`` equal to 1e-9), ``inference_on_dataset`` on
tensors, and the event writers. Every input is made here from a numpy seed.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slenderobjdet_torch.data import catalog as tcatalog
from slenderobjdet_torch.engine import events as tevents
from slenderobjdet_torch.evaluation import ar_recall as tar
from slenderobjdet_torch.evaluation import coco_api as tapi
from slenderobjdet_torch.evaluation import coco_evaluation as tce
from slenderobjdet_torch.evaluation import evaluator as tev
from slenderobjdet_torch.evaluation import native as tnative
from slenderobjdet_torch.evaluation import slender_cocoeval as tsc
from slenderobjdet_torch.structures import boxes as tboxes
from slenderobjdet_torch.structures import masks as tmasks
from slenderobjdet_tpu.data import catalog as jcatalog
from slenderobjdet_tpu.engine import events as jevents
from slenderobjdet_tpu.evaluation import ar_recall as jar
from slenderobjdet_tpu.evaluation import coco_api as japi
from slenderobjdet_tpu.evaluation import coco_evaluation as jce
from slenderobjdet_tpu.evaluation import native as jnative
from slenderobjdet_tpu.evaluation import slender_cocoeval as jsc
from slenderobjdet_tpu.structures import boxes as jboxes
from slenderobjdet_tpu.structures import masks as jmasks

ROOT = Path(__file__).resolve().parents[1]
NAME = "torch_eval_synth"
RESULT_TOL = 1e-9     # bbox and ar results, port vs JAX package


def gt_dataset(seed=0, num_images=10, num_cats=4):
    """A COCO dict with slender and compact boxes, rotated-rectangle
    polygons, crowd annotations and one image without annotations."""
    rs = np.random.RandomState(seed)
    cat_ids = [2 * i + 1 for i in range(num_cats)]
    images, anns = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        images.append({"id": img_id, "file_name": f"{img_id}.png", "height": 240,
                       "width": 320})
        for _ in range(0 if img_id == 4 else rs.randint(2, 7)):
            slender = rs.rand() < 0.5
            bw = rs.randint(60, 120) if slender else rs.randint(16, 80)
            bh = rs.randint(6, 14) if slender else rs.randint(16, 80)
            if rs.rand() < 0.3:
                bw, bh = bh, bw
            x, y = rs.randint(0, 320 - bw), rs.randint(0, 240 - bh)
            ann = {"id": ann_id, "image_id": img_id, "category_id": int(rs.choice(cat_ids)),
                   "bbox": [float(x), float(y), float(bw), float(bh)],
                   "area": float(bw * bh), "iscrowd": int(rs.rand() < 0.1)}
            kind = rs.randint(3)
            if kind == 0:       # the box itself
                ann["segmentation"] = [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]
            elif kind == 1:     # a thin diagonal quadrilateral: oriented ratio != bbox ratio
                ann["segmentation"] = [[x, y, x + 4, y, x + bw, y + bh, x + bw - 4, y + bh]]
            anns.append(ann)
            ann_id += 1
    cats = [{"id": c, "name": f"cat{i}", "supercategory": "obj"}
            for i, c in enumerate(cat_ids)]
    return {"images": images, "annotations": anns, "categories": cats}


def fixed_predictions(gt, seed=1):
    """Loader batches and fixed-shape model outputs: jittered copies of the
    gt boxes, some with a wrong class, and random boxes, padded to 20."""
    rs = np.random.RandomState(seed)
    cat_ids = [c["id"] for c in gt["categories"]]
    by_image = {}
    for a in gt["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)
    batches = []
    ids = [im["id"] for im in gt["images"]]
    for start in range(0, len(ids), 4):
        chunk = ids[start:start + 4]
        valid_rows = [True] * len(chunk) + [False] * (4 - len(chunk))
        chunk = chunk + [chunk[-1]] * (4 - len(chunk))
        boxes = np.zeros((4, 20, 4), np.float32)
        scores = np.zeros((4, 20), np.float32)
        classes = np.zeros((4, 20), np.int32)
        valid = np.zeros((4, 20), bool)
        for b, img_id in enumerate(chunk):
            n = 0
            for a in by_image.get(img_id, []):
                if rs.rand() < 0.8:
                    x, y, w, h = a["bbox"]
                    j = rs.randn(4) * 0.08 * min(w, h)
                    boxes[b, n] = [x + j[0], y + j[1], x + w + j[2], y + h + j[3]]
                    cid = a["category_id"] if rs.rand() < 0.85 else int(rs.choice(cat_ids))
                    classes[b, n] = cat_ids.index(cid)
                    scores[b, n] = rs.rand()
                    valid[b, n] = True
                    n += 1
            for _ in range(rs.randint(0, 5)):
                x, y = rs.rand(2) * [250, 180]
                boxes[b, n] = [x, y, x + rs.rand() * 60 + 4, y + rs.rand() * 60 + 4]
                classes[b, n] = rs.randint(len(cat_ids) + 1)    # one class beyond the json's
                scores[b, n] = rs.rand() * 0.5
                valid[b, n] = True
                n += 1
        batches.append(({"image_id": chunk, "batch_valid": valid_rows},
                        {"boxes": boxes, "scores": scores, "classes": classes,
                         "valid": valid}))
    return batches


@pytest.fixture(scope="module")
def registered(tmp_path_factory):
    gt = gt_dataset()
    path = tmp_path_factory.mktemp("torch_eval") / "instances.json"
    path.write_text(json.dumps(gt))
    id_map = {c["id"]: i for i, c in enumerate(gt["categories"])}
    for catalog in (jcatalog, tcatalog):
        catalog.MetadataCatalog.get(NAME).set(
            json_file=str(path), thing_dataset_id_to_contiguous_id=id_map,
            evaluator_type="coco")
    return gt, str(path)


def assert_results_close(got, want, path=""):
    assert type(got) is type(want) or isinstance(got, (int, float)), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_results_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_results_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == pytest.approx(want, abs=RESULT_TOL, rel=RESULT_TOL), path


# ------------------------------------------------------------ geometry, api
def test_slenderness_geometry_equals_the_jax_package():
    rs = np.random.RandomState(2)
    for _ in range(25):
        n = rs.randint(3, 9)
        polys = [rs.rand(2 * n) * 200 for _ in range(rs.randint(1, 3))]
        assert tmasks.ratio_of_polygon(polys) == jmasks.ratio_of_polygon(polys)
        assert tmasks.rbox_from_polygon(polys) == jmasks.rbox_from_polygon(polys)
    line = [np.array([0, 0, 10, 10, 20, 20.0])]           # degenerate hull
    assert tmasks.ratio_of_polygon(line) == jmasks.ratio_of_polygon(line)
    for box in ([0, 0, 10, 40], [5, 5, 5, 9], [0, 0, 30, 3.0]):
        assert tmasks.ratio_of_bbox_xyxy(box) == jmasks.ratio_of_bbox_xyxy(box)
    for ann in gt_dataset(seed=3)["annotations"]:
        for oriented in (True, False):
            assert tmasks.compute_ann_ratio(dict(ann), oriented) == \
                jmasks.compute_ann_ratio(dict(ann), oriented)
    assert tmasks.compute_ann_ratio({"ratio": 0.25, "bbox": [0, 0, 1, 1]}) == 0.25


def test_ratio_of_a_rotated_slender_polygon_is_the_oriented_one():
    """A 100 x 8 rectangle turned by 30 degrees: its bbox ratio is about
    0.54 and its oriented ratio 0.08. The port, which has no cv2 branch,
    gives the JAX package's oriented ratio (cv2.minAreaRect) exactly."""
    t = np.deg2rad(30.0)
    u, v = np.array([np.cos(t), np.sin(t)]), np.array([-np.sin(t), np.cos(t)])
    corners = [200 + a * 50 * u + b * 4 * v for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    polys = [np.round(np.concatenate(corners), 3)]
    pts = polys[0].reshape(-1, 2)
    bbox_ratio = tmasks.ratio_of_bbox_xyxy([*pts.min(0), *pts.max(0)])
    want = jmasks.ratio_of_polygon(polys)
    assert want == pytest.approx(0.08, abs=1e-4) and bbox_ratio > 0.5
    assert tmasks.ratio_of_polygon(polys) == want
    assert not hasattr(tmasks, "_HAS_CV2") and not hasattr(tmasks, "cv2")


def test_coco_api_equals_the_jax_package(registered):
    gt, path = registered
    want, got = japi.COCO(path), tapi.COCO(path)
    assert got.dataset == want.dataset and got.anns == want.anns
    assert {a["id"]: a["ratio"] for a in got.dataset["annotations"]} == {
        a["id"]: a["ratio"] for a in want.dataset["annotations"]}
    assert any(a["ratio"] < 0.2 for a in got.anns.values())
    for kw in ({}, {"imgIds": [1, 2]}, {"catIds": [3]}, {"imgIds": 5, "iscrowd": 0},
               {"areaRng": [500, 3000]}, {"imgIds": [1, 2, 3], "catIds": [1, 5]}):
        assert got.getAnnIds(**kw) == want.getAnnIds(**kw), kw
    assert got.getCatIds() == want.getCatIds() == [1, 3, 5, 7]
    assert got.getCatIds(catNms=["cat1"]) == want.getCatIds(catNms=["cat1"]) == [3]
    assert sorted(got.getImgIds(catIds=[3])) == sorted(want.getImgIds(catIds=[3]))
    assert got.loadImgs(4) == want.loadImgs(4) and got.loadCats([1, 7]) == want.loadCats([1, 7])
    dts = [{"image_id": 1, "category_id": 3, "bbox": [1.0, 2.0, 30.0, 6.0], "score": 0.5},
           {"image_id": 2, "category_id": 1, "bbox": [4.0, 4.0, 10.0, 10.0], "score": 0.25}]
    res_w, res_g = want.loadRes([dict(d) for d in dts]), got.loadRes([dict(d) for d in dts])
    assert res_g.dataset["annotations"] == res_w.dataset["annotations"]
    assert res_g.dataset["annotations"][0]["ratio"] == pytest.approx(0.2)
    assert got.loadRes([]).dataset["annotations"] == []
    with pytest.raises(AssertionError, match="correspond"):
        got.loadRes([{"image_id": 999, "category_id": 1, "bbox": [0, 0, 1, 1], "score": 1}])
    oriented_off = tapi.COCO(json.loads(Path(path).read_text()), oriented=False)
    assert oriented_off.anns[1]["ratio"] == japi.COCO(
        json.loads(Path(path).read_text()), oriented=False).anns[1]["ratio"]


def test_numpy_box_math_equals_the_jax_package():
    rs = np.random.RandomState(4)
    a = rs.rand(9, 4) * 80
    b = rs.rand(6, 4) * 80
    a[0] = [5, 5, 0, 0]                   # empty boxes: the union is 0
    b[0] = [5, 5, 0, 0]
    for arr in (a, b):
        np.testing.assert_array_equal(tboxes.xywh_to_xyxy(arr), jboxes.xywh_to_xyxy(arr))
    a, b = tboxes.xywh_to_xyxy(a), tboxes.xywh_to_xyxy(b)
    np.testing.assert_array_equal(tboxes.area(a), jboxes.area(a))
    np.testing.assert_array_equal(tboxes.pairwise_intersection(a, b),
                                  jboxes.pairwise_intersection(a, b))
    want = jboxes.pairwise_iou(a, b)
    np.testing.assert_array_equal(tboxes.pairwise_iou(a, b), want)
    assert want[0, 0] == 0.0 and want.max() > 0.1
    # the same functions on tensors, the same order of operations
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tboxes.xywh_to_xyxy(torch.from_numpy(a)).numpy(), jboxes.xywh_to_xyxy(a))


def test_bbox_iou_xywh_equals_the_jax_package():
    rs = np.random.RandomState(5)
    dt, gt = rs.rand(7, 4) * 50 + 1, rs.rand(5, 4) * 50 + 1
    crowd = [0, 1, 0, 0, 1]
    np.testing.assert_array_equal(tsc.bbox_iou_xywh(dt, gt, crowd),
                                  jsc.bbox_iou_xywh(dt, gt, crowd))
    assert tsc.bbox_iou_xywh(np.zeros((0, 4)), gt, crowd).shape == (0, 5)


# ------------------------------------------------------------ the C matcher
def test_c_matcher_builds_under_build_and_matches_the_source(registered):
    assert (Path(tnative.__file__).parent / "csrc/slender_eval.c").read_bytes() == (
        ROOT / "slenderobjdet_tpu/evaluation/csrc/slender_eval.c").read_bytes()
    assert tnative.available() and tnative.backend() == "c"
    so = tnative.library_path()
    assert so.exists() and ROOT / "build" / "slender_eval" in so.parents
    assert not list((Path(tnative.__file__).parent / "csrc").glob("*.so"))
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "/build/" in ignored


def test_backend_is_numpy_where_no_compiler_exists(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "nowhere")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not tnative.available() and tnative.backend() == "numpy"


def load_jax_matcher(monkeypatch):
    """The JAX package's C matcher, loaded now. Its loader rebuilds the
    tracked ``.so`` in place at collection time when a checkout left it older
    than its source, in every worker at once; a worker that loaded a
    half-written file keeps the numpy path from then on (``_tried``). By
    test time the file is whole: load it again, and it must load."""
    if jnative._lib is None:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()


def _run_cocoeval(module, api, path, dts, use_native):
    coco = api.COCO(path)
    ev = module.SlenderCOCOeval(coco, coco.loadRes([dict(d) for d in dts]), "bbox")
    ev.use_native = use_native
    ev.evaluate()
    ev.accumulate()
    return ev, ev.summarize()


def _coco_results(gt):
    ev = tce.COCOEvaluator(NAME)
    for batch, outputs in fixed_predictions(gt):
        ev.process(batch, outputs)
    return [inst for p in ev._predictions for inst in p["instances"]]


@pytest.mark.parametrize("use_native", [True, False], ids=["c_matcher", "numpy_path"])
def test_slender_cocoeval_equals_the_jax_package(registered, use_native, monkeypatch):
    if use_native:
        load_jax_matcher(monkeypatch)
    gt, path = registered
    dts = _coco_results(gt)
    assert len(dts) > 30
    want_ev, want = _run_cocoeval(jsc, japi, path, dts, use_native)
    got_ev, got = _run_cocoeval(tsc, tapi, path, dts, use_native)
    np.testing.assert_array_equal(got, want)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got_ev.eval[k], want_ev.eval[k])
    assert 0.05 < got[0] < 0.95 and got[3] > -1      # an AP, and slender gt exist
    # the C matcher and the numpy path of the port agree with each other
    _, other = _run_cocoeval(tsc, tapi, path, dts, not use_native)
    np.testing.assert_array_equal(got, other)


def test_params_equal_the_jax_package():
    want, got = jsc.SlenderParams(), tsc.SlenderParams()
    assert got.aptrtoRng == want.aptrtoRng and got.aptrtoRngLbl == want.aptrtoRngLbl
    assert got.maxDets == want.maxDets
    np.testing.assert_array_equal(got.iouThrs, want.iouThrs)
    np.testing.assert_array_equal(got.recThrs, want.recThrs)
    with pytest.raises(AssertionError):
        tsc.SlenderCOCOeval(iouType="segm")


# -------------------------------------------------------------- evaluators
def test_ar_matrix_equals_the_jax_package(registered):
    gt, path = registered
    ev = tce.COCOEvaluator(NAME)
    for batch, outputs in fixed_predictions(gt):
        ev.process(batch, outputs)
    id_map = {c["id"]: i for i, c in enumerate(gt["categories"])}
    want = jar.evaluate_predictions_ar(ev._predictions, japi.COCO(path), id_map, limit=5)
    got = tar.evaluate_predictions_ar(ev._predictions, tapi.COCO(path), id_map, limit=5)
    for k in ("ar", "mar", "recalls", "thresholds", "num_pos"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < got["ar"] < 1
    assert tar.ASPECT_RATIOS == jar.ASPECT_RATIOS and tar.AREAS == jar.AREAS
    np.testing.assert_array_equal(tar.between_ranges(0.2, list(tar.ASPECT_RATIOS.values())),
                                  jar.between_ranges(0.2, list(jar.ASPECT_RATIOS.values())))


@pytest.mark.parametrize("use_native", [True, False], ids=["c_matcher", "numpy_path"])
def test_coco_evaluator_equals_the_jax_package(registered, use_native, tmp_path, monkeypatch):
    """(b): the same fixed predictions through both COCOEvaluators."""
    if use_native:
        load_jax_matcher(monkeypatch)
    gt, _ = registered
    monkeypatch.setattr(jsc.SlenderCOCOeval, "use_native", use_native, raising=False)
    monkeypatch.setattr(tsc.SlenderCOCOeval, "use_native", use_native, raising=False)
    results = []
    for module, out in ((jce, tmp_path / "jax"), (tce, tmp_path / "torch")):
        ev = module.COCOEvaluator(NAME, output_dir=str(out))
        for batch, outputs in fixed_predictions(gt):
            ev.process(batch, outputs)
        results.append(ev.evaluate())
    want, got = results
    assert list(got) == ["bbox", "ar"]
    assert_results_close(dict(got), dict(want))
    assert set(tce.STATS_NAMES) <= set(got["bbox"]) and tce.STATS_NAMES == jce.STATS_NAMES
    assert 5 < got["bbox"]["AP"] < 95 and got["bbox"]["AP-0-1/5"] > -100
    assert set(got["bbox"]["AP-per-category"]) == {"cat0", "cat1", "cat2", "cat3"}
    assert got["ar"]["AR@100"] > 0
    for name in ("coco_instances_results.json", "evaluate_metrics.json"):
        assert json.loads((tmp_path / "torch" / name).read_text()) == json.loads(
            (tmp_path / "jax" / name).read_text())


def test_coco_evaluator_without_detections_reports_nan(registered):
    gt, _ = registered
    ev = tce.COCOEvaluator(NAME)
    batch, outputs = fixed_predictions(gt)[0]
    ev.process(batch, dict(outputs, valid=np.zeros_like(outputs["valid"])))
    res = ev.evaluate()
    assert list(res["bbox"]) == tce.STATS_NAMES
    assert all(math.isnan(v) for v in res["bbox"].values())
    assert res["ar"]["AR@100"] == 0.0
    ev.reset()
    assert ev._predictions == []


def test_evaluator_with_anchors_equals_the_jax_package(registered, tmp_path):
    gt, _ = registered
    results = []
    for module, out in ((jce, tmp_path / "jax"), (tce, tmp_path / "torch")):
        ev = module.COCOEvaluatorWithAnchors(NAME, output_dir=str(out))
        for batch, outputs in fixed_predictions(gt):
            extra = {"anchors": outputs["boxes"] + 1.0,
                     "proposals": outputs["boxes"], "proposal_scores": outputs["scores"],
                     "proposal_valid": outputs["valid"], "proposal_anchors": outputs["boxes"] - 1}
            ev.process(batch, {**outputs, **extra})
        results.append((ev.evaluate(), ev._predictions, ev._proposals))
    (want, wp, wprop), (got, gp, gprop) = results
    assert_results_close(dict(got), dict(want))
    assert gp == wp and "anchor" in gp[0]["instances"][0]
    assert len(gprop) == len(wprop) == 10
    assert (tmp_path / "torch" / "box_proposals.pkl").exists()


def test_inference_on_dataset_fetches_tensors_once_a_batch(registered):
    """Detections arrive as tensors (bfloat16 scores among them) and reach
    the evaluator as numpy arrays; the result carries the timing block."""
    gt, _ = registered
    fixed = fixed_predictions(gt)
    outputs = iter([o for _, o in fixed])

    def predict_fn(batch):
        out = next(outputs)
        return {"boxes": torch.from_numpy(out["boxes"]),
                "scores": torch.from_numpy(out["scores"]).to(torch.bfloat16),
                "classes": torch.from_numpy(out["classes"]),
                "valid": torch.from_numpy(out["valid"])}

    seen = []

    class Recorder(tce.COCOEvaluator):
        def process(self, batch, outs):
            seen.append({k: (type(v), v.dtype) for k, v in outs.items()})
            super().process(batch, outs)

    res = tev.inference_on_dataset(predict_fn, [b for b, _ in fixed], Recorder(NAME), warmup=1)
    assert all(t is np.ndarray for s in seen for t, _ in s.values())
    assert seen[0]["scores"][1] == np.float32 and seen[0]["valid"][1] == np.bool_
    assert res["_timing"]["images"] == 6 and res["_timing"]["s_per_img"] > 0
    assert "bbox" in res and "ar" in res

    want = tce.COCOEvaluator(NAME)
    for batch, out in fixed:
        want.process(batch, dict(out, scores=torch.from_numpy(out["scores"]).to(
            torch.bfloat16).float().numpy()))
    assert_results_close(dict((k, v) for k, v in res.items() if k != "_timing"),
                         dict(want.evaluate()))


def test_pipe_table():
    table = tce._pipe_table(["category", "AP"], [("cat0", 12.5), ("longer name", None)])
    assert table.splitlines() == ["| category    | AP     |", "|:------------|:-------|",
                                  "| cat0        | 12.500 |", "| longer name |        |"]


# ------------------------------------------------------------------ events
def test_event_storage_and_writers_equal_the_jax_package(tmp_path):
    rs = np.random.RandomState(7)
    stores = [jevents.EventStorage(start_iter=3), tevents.EventStorage(start_iter=3)]
    writers = [jevents.JSONWriter(str(tmp_path / "jax" / "metrics.json")),
               tevents.JSONWriter(str(tmp_path / "torch" / "metrics.json"))]
    for _ in range(25):
        loss, dt = rs.rand(), rs.rand()
        for s, w in zip(stores, writers):
            s.put_scalars(total_loss=np.float32(loss), data_time=dt)
            w.write(s)
            s.step()
    want, got = stores
    assert got.iter == want.iter == 28 and got.latest() == want.latest()
    assert got.median("total_loss") == want.median("total_loss")
    assert got.median("nope") == 0.0
    for w in writers:
        w.close()
    lines = (tmp_path / "torch" / "metrics.json").read_text().splitlines()
    assert lines == (tmp_path / "jax" / "metrics.json").read_text().splitlines()
    assert len(lines) == 25 and json.loads(lines[0])["iteration"] == 3
    tevents.CommonMetricPrinter(100).write(got)
