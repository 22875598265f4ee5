"""The port's model-driving tools against the JAX package's on the CPU:
``inference_obj365``, ``eval_and_save_proposals`` and ``vis_feat_adaption``,
each run in this process beside its JAX counterpart (``tools/*.py``, whose
``main`` reads ``sys.argv``) on the same synthetic dataset, tiny R-18
configs in fp32 with exact top-k, and the same weights: drawn in numpy from
the JAX init's manifest (``checkpoint/bridge.py:seeded_flax_variables``),
handed to the JAX tool in place of its own init and to the port's tool as a
``--weights`` checkpoint through the bridge. Each JAX detector compiles once.

Tolerances (fp32, different conv sum orders): boxes ``BOX_ATOL`` px
(measured 7.6e-6), scores ``SCORE_ATOL`` (measured 1.0e-6), objectness
logits ``SCORE_ATOL`` of the largest |logit| (measured 0.0215 on logits in
the thousands: He-normal weights), metrics equal to 1e-9.
"""

import importlib.util
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

import slenderobjdet_tpu.models as jmodels  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict, manifest_of,  # noqa: E402
                                                   seeded_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.tools import (eval_and_save_proposals, inference_obj365,  # noqa: E402
                                       vis_feat_adaption)
from slenderobjdet_torch.utils import draw, png  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = "torch_tools_synth"
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-5
TINY = {"MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", "TPU.APPROX_TOPK": False,
        "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128, "DATALOADER.NUM_WORKERS": 0,
        "DATASETS.TEST": (NAME,)}
YAMLS = {"fcos": ("configs/fcos/fcos_R_50_FPN_1x.yaml", {}),
         "rcnn": ("configs/faster/faster_rcnn_R_50_FPN_1x.yaml", {
             "MODEL.META_ARCHITECTURE": "ProposalVisibleRCNNWithAnchor",
             "MODEL.RPN.PRE_NMS_TOPK_TEST": 100, "MODEL.RPN.POST_NMS_TOPK_TEST": 50}),
         "reppoints": ("configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml", {})}


def rule(name, shape):
    """He-normal kernels, FrozenBN away from identity, zero biases; the RPN's
    delta kernels zero, so that its proposals are its anchors (He-normal
    deltas send every box to the decoding clamp)."""
    leaf = name.rsplit("/", 1)[-1]
    if "anchor_deltas" in name:
        return "zeros"
    if name.startswith("buffers/"):
        return {"scale": "frozen_bn_scale", "bias": "frozen_bn_bias"}.get(leaf, "ones")
    return {"kernel": "he_normal", "bias": "zeros"}.get(leaf, "ones")


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tools")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80), seed=4)
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    return {"tmp": tmp, "json": path, "root": root}


@pytest.fixture(scope="module")
def family(synth):
    """Per family: the config file both tools read, the JAX detector, the
    drawn Flax tree and the port's checkpoint of it."""
    out = {}
    for key, (yaml, extra) in YAMLS.items():
        cfg = torch_get_cfg()
        cfg.merge_from_file(str(ROOT / yaml))
        cfg.merge_from_list([x for kv in {**TINY, **extra}.items() for x in kv])
        cfg_file = synth["tmp"] / f"{key}.yaml"
        cfg_file.write_text(cfg.dump())
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(str(cfg_file))
        jcfg.freeze()
        det = jmodels.build_model(jcfg)
        manifest = manifest_of(jax.eval_shape(det.init_variables, jax.random.PRNGKey(0)), rule)
        variables = seeded_flax_variables(manifest, seed=40 + len(out))
        weights = synth["tmp"] / f"{key}.pth"
        torch.save({"model": flax_to_state_dict(variables), "iteration": 0}, weights)
        out[key] = {"cfg": str(cfg_file), "det": det, "variables": variables,
                    "weights": str(weights)}
    return out


def inject(monkeypatch, fam):
    """The JAX tools build their detector inside ``main``: hand them the
    module's detector (compiled once) with the drawn tree as its init."""
    det, variables = fam["det"], jax.tree_util.tree_map(jax.numpy.asarray, fam["variables"])
    monkeypatch.setattr(det, "init_variables", lambda *a, **k: variables, raising=False)
    monkeypatch.setattr(jmodels, "build_model", lambda cfg: det)
    return det, variables


def match_instances(got, want):
    """COCO result lists: the same (image, category) pairs, scores within
    SCORE_ATOL and boxes within BOX_ATOL after sorting each pair's entries by
    score."""
    def key(d):
        return (d["image_id"], d["category_id"], -d["score"])
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL, (g, w)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=BOX_ATOL)


def assert_nested_close(got, want, path="metrics"):
    """Nested dicts and lists of floats: the same keys, values within 1e-9,
    NaN where NaN."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_nested_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_nested_close(g, w, f"{path}[{i}]")
    else:
        assert got == pytest.approx(want, abs=1e-9, nan_ok=True), path


def test_inference_obj365_matches_the_jax_tool(synth, family, monkeypatch):
    fam, tmp = family["fcos"], synth["tmp"]
    argv = ["--config-file", fam["cfg"], "--gt-json", synth["json"], "--image-root",
            synth["root"], "--batch-size", "2", "--chunk", "2"]
    mod = jax_tool("inference_obj365")
    det, variables = inject(monkeypatch, fam)

    def build_and_load(cfg, weights):
        det._variables = variables
        return det

    monkeypatch.setattr(mod, "build_and_load", build_and_load)
    monkeypatch.setattr(sys, "argv", ["inference_obj365", *argv, "--out-dir", str(tmp / "jax_obj")])
    mod.main()
    got_metrics = inference_obj365.main(argv + ["--out-dir", str(tmp / "obj"), "--weights",
                                                fam["weights"], "--device", "cpu"])
    files = sorted(os.listdir(tmp / "obj"))
    assert files == sorted(os.listdir(tmp / "jax_obj"))
    assert {"results_chunk_0000.json", "results_chunk_0002.json", "obj365_metrics.json",
            "coco_instances_results.json"} <= set(files)
    for f in files:
        if f.startswith("results_chunk") or f == "coco_instances_results.json":
            match_instances(json.loads((tmp / "obj" / f).read_text()),
                            json.loads((tmp / "jax_obj" / f).read_text()))
    got = json.loads((tmp / "obj" / "obj365_metrics.json").read_text())
    want = json.loads((tmp / "jax_obj" / "obj365_metrics.json").read_text())
    assert_nested_close(got, want)
    assert "AP" in got_metrics["bbox"]


def test_eval_and_save_proposals_matches_the_jax_tool(synth, family, monkeypatch):
    fam, tmp = family["rcnn"], synth["tmp"]
    inject(monkeypatch, fam)
    mod = jax_tool("eval_and_save_proposals")
    monkeypatch.setattr(sys, "argv", ["eval_and_save_proposals", "--config-file", fam["cfg"],
                                      "--out", str(tmp / "jax_props.pkl"), "--max-images", "5"])
    mod.main()
    got = eval_and_save_proposals.main(["--config-file", fam["cfg"], "--out",
                                        str(tmp / "props.pkl"), "--max-images", "5",
                                        "--weights", fam["weights"], "--device", "cpu"])
    with open(tmp / "jax_props.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp / "props.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == sorted(want) == sorted(got)
    assert got["ids"] == want["ids"] and len(got["ids"]) == 6    # the tool stops after a batch
    assert got["bbox_mode"] == want["bbox_mode"] == "XYXY_ABS"
    for k in ("boxes", "anchors", "objectness_logits"):
        for g, w in zip(got[k], want[k]):
            assert g.shape == w.shape and len(g) > 0, k
            np.testing.assert_allclose(g, w, rtol=0, atol=BOX_ATOL if k != "objectness_logits"
                                       else SCORE_ATOL * max(1.0, np.abs(w).max()), err_msg=k)


def test_vis_feat_adaption_matches_the_jax_tool(synth, family, monkeypatch):
    """The JAX tool's cv2 calls are recorded with the canvas before the
    first: its centres equal the port's, its points the port's within the
    pixel its ``int`` truncation takes; the port's primitives replaying the
    JAX calls on that canvas give the JAX image pixel for pixel, and the
    port's PNG is its own points drawn on the same canvas."""
    fam, tmp = family["reppoints"], synth["tmp"]
    inject(monkeypatch, fam)
    mod = jax_tool("vis_feat_adaption")
    calls, canvas, images = [], [], {}
    real_circle, real_line = mod.cv2.circle, mod.cv2.line

    def circle(img, c, r, col, t):
        if not calls:
            canvas.append(img.copy())
        calls.append(("circle", c, r, col))
        return real_circle(img, c, r, col, t)

    def line(img, p, q, col, t):
        calls.append(("line", p, q, col))
        return real_line(img, p, q, col, t)

    def imwrite(path, img):
        images[Path(path).stem] = (canvas.pop(), img.copy(), list(calls))
        calls.clear()
        return True

    monkeypatch.setattr(mod.cv2, "circle", circle)
    monkeypatch.setattr(mod.cv2, "line", line)
    monkeypatch.setattr(mod.cv2, "imwrite", imwrite)
    argv = ["--config-file", fam["cfg"], "--gt-json", synth["json"], "--image-root",
            synth["root"], "--num-images", "2", "--top-locations", "12"]
    monkeypatch.setattr(sys, "argv", ["vis_feat_adaption", *argv, "--out-dir", "x"])
    mod.main()
    recorded = []
    real_sets = vis_feat_adaption.top_point_sets
    monkeypatch.setattr(vis_feat_adaption, "top_point_sets",
                        lambda *a: recorded.append(real_sets(*a)) or recorded[-1])
    paths = vis_feat_adaption.main(argv + ["--out-dir", str(tmp / "adapt"), "--weights",
                                           fam["weights"], "--device", "cpu"])
    assert sorted(Path(p).stem for p in paths) == sorted(images) and len(paths) == 2
    for path, sets in zip(paths, recorded):
        base, want, want_calls = images[Path(path).stem]
        centers = [a for kind, a, r, _ in want_calls if kind == "circle" and r == 3]
        assert [(int(c[0]), int(c[1])) for c, _ in sets] == centers and len(centers) == 12
        jax_pts = np.array([q for kind, _, q, _ in want_calls if kind == "line"], np.float64)
        port_pts = np.concatenate([pts for _, pts in sets])
        assert np.abs(port_pts - jax_pts).max() < 1 + BOX_ATOL
        far = np.abs(port_pts - np.round(port_pts)) > BOX_ATOL     # not at an integer
        np.testing.assert_array_equal(np.trunc(port_pts)[far], jax_pts[far])
        replay = base.copy()
        for kind, a, b, col in want_calls:
            if kind == "circle":
                draw.circle_filled(replay, a, b, col)
            else:
                draw.line(replay, a, b, col)
        np.testing.assert_array_equal(replay, want)
        np.testing.assert_array_equal(png.imread(path),
                                      vis_feat_adaption.draw_point_sets(base.copy(), sets))
