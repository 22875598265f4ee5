"""The port's root tools against the JAX package's scripts on the CPU.

Each JAX script (``tools/*.py``, whose ``main`` reads ``sys.argv``) runs in
this process beside its port (``slenderobjdet_torch/tools/*.py``, whose
``main`` takes ``argv`` and returns what it printed or dumped), on the same
inputs:

- ``convergence_run``: tiny FCOS R-18 (fp32, exact top-k) at 64 x 64, B = 2,
  3 steps, both sides from one Flax tree drawn in numpy
  (``checkpoint/bridge.py:seeded_flax_variables``): every step's loss within
  ``LOSS_RTOL``, the same JSON keys,
  the held-out detections above the score cut paired by class, box and
  score, and precision and recall equal. The JAX step compiles once.
- ``data_time``: with cv2 the same dataset dicts, stage rows and batch
  shapes and keys as the JAX script; through the PNG path (no cv2) the same
  shapes and keys. No time is compared.
- ``compare_matchers``: the printed positive-anchor counts equal, on
  integer-pixel boxes (ties).
- the readers ``result_statistic``, ``ar_result``, ``coco_class_info``,
  ``data_statistic`` and ``regression``: the same printed text (the COCO
  API's timings blanked), and the same pickled metrics within 1e-9; the
  evaluator's per-category table as ``tabulate`` prints it.
- the launchers: ``run_experiments``' commands equal to the JAX script's
  with ``train_net.py`` swapped for ``train_net_torch.py``, and its retry
  loop over a ``subprocess.call`` stub that fails twice; ``watch_evaluate
  --once``: the marker and ``result_statistic``'s metrics.
- every module of the port and ``chip_smoke.py`` imported in a fresh
  interpreter leave jax, the JAX package and cv2 out of ``sys.modules``.

Every input is drawn from a seed here; no test takes the session ``rng``.
"""

import contextlib
import importlib.util
import io
import itertools
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402
from torch_threads import one_torch_thread_module  # noqa: E402,F401

import slenderobjdet_tpu.data as jdata  # noqa: E402
import slenderobjdet_tpu.engine.train_loop as jtrain_loop  # noqa: E402
import slenderobjdet_tpu.models as jmodels  # noqa: E402
import slenderobjdet_tpu.solver as jsolver  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict, manifest_of,  # noqa: E402
                                                   seeded_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.tools import (ar_result, coco_class_info, compare_matchers,  # noqa: E402
                                       convergence_run, data_statistic, data_time,
                                       regression, result_statistic, run_experiments,
                                       watch_evaluate)
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
FCOS_YAML = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
RCNN_YAML = ROOT / "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"
NAME = "torch_root_tools_synth"
TINY = {"MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", "TPU.APPROX_TOPK": False}
CONV_ARGS = ["--steps", "3", "--batch", "2", "--hw", "64", "64", "--log-every", "1",
             "--lr", "1e-3", "--num-classes", "4", "--seed", "3"]
LOSS_RTOL = 1e-5           # every step; measured: step 1 equal, steps 2-3 within 1.6e-7
BOX_ATOL = 1e-3            # px, held-out detections (measured 5.7e-6)
SCORE_ATOL = 1e-5          # measured 8.3e-7
METRIC_ATOL = 1e-9


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_root_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def untimed(text):
    """Printed text with the COCO API's timings blanked: its "(t=0.01s)" and
    its "loading annotations took 0.01s"."""
    return re.sub(r"took [0-9.]+s", "took ?s", re.sub(r"t=[0-9.]+s", "t=?s", text))


def run_jax(mp, name, argv):
    """The JAX script ``name``'s main with ``argv``; returns its stdout."""
    mod = jax_tool(name)
    mp.setattr(sys, "argv", [name, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return untimed(out.getvalue())


def run_port(fn, argv):
    """The port's ``fn(argv)``; returns (its result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, untimed(out.getvalue())


def assert_nested_close(got, want, path="metrics"):
    """Nested dicts and lists of floats: the same keys, values within
    METRIC_ATOL, NaN where NaN."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_nested_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_nested_close(g, w, f"{path}[{i}]")
    else:
        assert got == pytest.approx(want, abs=METRIC_ATOL, nan_ok=True), path


def tiny_yaml(path, yaml=FCOS_YAML, extra=()):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list([x for kv in TINY.items() for x in kv] + list(extra))
    path.write_text(cfg.dump())
    return str(path)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A COCO json of 6 PNG images (integer-pixel boxes, slender ones among
    them) in both catalogs, and a results json: its gt jittered by a seeded
    draw and scored."""
    tmp = tmp_path_factory.mktemp("torch_root_tools")
    path, root = make_coco_json(tmp, num_images=6, seed=5, slender=True)
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    rs = np.random.RandomState(6)
    with open(path) as f:
        gt = json.load(f)
    results = [{"image_id": a["image_id"], "category_id": a["category_id"],
                "bbox": [v + rs.randn() for v in a["bbox"]], "score": float(rs.rand())}
               for a in gt["annotations"]]
    results_json = tmp / "coco_instances_results.json"
    results_json.write_text(json.dumps(results))
    return {"tmp": tmp, "json": path, "root": root, "results": str(results_json)}


# ----------------------------------------------------------- convergence_run
def rule(name, shape):
    """He-normal kernels, FrozenBN away from identity, zero biases."""
    leaf = name.rsplit("/", 1)[-1]
    if name.startswith("buffers/"):
        return {"scale": "frozen_bn_scale", "bias": "frozen_bn_bias"}.get(leaf, "ones")
    return {"kernel": "he_normal", "bias": "zeros"}.get(leaf, "ones")


@pytest.fixture(scope="module")
def convergence(synth):
    """Both scripts' runs: (JAX losses, JAX stdout, JAX held-out outputs),
    (the port's result, stdout, held-out outputs)."""
    tmp = synth["tmp"]
    cfg_file = tiny_yaml(tmp / "convergence.yaml")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.MODEL.FCOS.NUM_CLASSES = 4               # the script's model edit
    jcfg.freeze()
    det = jmodels.build_model(jcfg)
    variables = seeded_flax_variables(
        manifest_of(jax.eval_shape(det.init_variables, jax.random.PRNGKey(0)), rule), seed=21)
    # boxes of about 18 x 18 px (ltrb = exp(reg)), so that some held-out
    # detections of P3 meet a 20 x 20 gt at IoU 0.5 and count as hits
    pred = variables["params"]["head"]["bbox_pred"]
    pred["kernel"] *= np.float32(0.02)
    pred["bias"][:] = np.float32(np.log(9.0))
    weights = tmp / "convergence.pth"
    torch.save({"model": flax_to_state_dict(variables), "iteration": 0}, weights)
    argv = ["--config-file", cfg_file, *CONV_ARGS]

    jax_losses, jax_outs = [], []
    real_step = jtrain_loop.make_train_step
    real_predict = det.predict

    def make_train_step(detector, tx, *a, **k):
        step = real_step(detector, tx, *a, **k)

        def run(state, batch):
            state, metrics = step(state, batch)
            jax_losses.append(float(metrics["total_loss"]))
            return state, metrics
        return run

    def predict(v, batch):
        out = real_predict(v, batch)
        jax.debug.callback(lambda o: jax_outs.append(jax.tree_util.tree_map(np.asarray, o)),
                           out, ordered=True)
        return out

    # the script calls build_optimizer(cfg, None): its parameter labels and
    # freeze mask are trees over the parameters, and optax rejects a None
    # mask at init, so the script is handed the drawn tree's parameters
    real_optimizer = jsolver.build_optimizer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(det, "init_variables", lambda *a, **k: jax.tree_util.tree_map(
            jax.numpy.asarray, variables), raising=False)
        mp.setattr(jsolver, "build_optimizer",
                   lambda cfg, params: real_optimizer(cfg, variables["params"]))
        mp.setattr(det, "predict", predict, raising=False)
        mp.setattr(jmodels, "build_model", lambda cfg: det)
        mp.setattr(jtrain_loop, "make_train_step", make_train_step)
        jax_stdout = run_jax(mp, "convergence_run", argv)

    port_outs = []
    real_build = convergence_run.build_and_load

    def build_and_load(*a, **k):
        model = real_build(*a, **k)
        model_predict = model.predict

        def recorded(batch):
            out = model_predict(batch)
            port_outs.append({k: v.numpy() for k, v in out.items()})
            return out
        model.predict = recorded
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convergence_run, "build_and_load", build_and_load)
        res, stdout = run_port(convergence_run.main,
                               argv + ["--weights", str(weights), "--device", "cpu"])
    return {"jax": (jax_losses, jax_stdout, jax_outs), "port": (res, stdout, port_outs)}


def test_convergence_run_losses_match_the_jax_script(convergence):
    jax_losses, jax_stdout, _ = convergence["jax"]
    res, stdout, _ = convergence["port"]
    losses = [loss for _, loss in res["log"]]
    assert [it for it, _ in res["log"]] == [1, 2, 3] and len(jax_losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    got_lines = [line.split(" (")[0] for line in stdout.splitlines()[:-1]]
    want_lines = [line.split(" (")[0] for line in jax_stdout.splitlines()[:-1]]
    assert [line.split(" loss=")[0] for line in got_lines] == \
        [line.split(" loss=")[0] for line in want_lines] == [f"iter {i}/3" for i in (1, 2, 3)]


def paired(got, want):
    """Detections above the script's score cut, image by image: each one of
    ``want`` pairs with one of ``got`` of its class within BOX_ATOL and
    SCORE_ATOL, and the other way round; a detection within SCORE_ATOL of
    the cut may be missing from the other side. Returns the pairs."""
    pairs = 0
    for g_out, w_out in zip(got, want):
        for i in range(len(w_out["scores"])):
            sides = []
            for out in (g_out, w_out):
                keep = out["valid"][i] & (out["scores"][i] > convergence_run.SCORE_THRESH)
                sides.append([(int(c), float(s), b) for c, s, b in zip(
                    out["classes"][i][keep], out["scores"][i][keep], out["boxes"][i][keep])])
            for a, b in (sides, sides[::-1]):
                free = list(b)
                for c, s, box in a:
                    hit = next((d for d in free if d[0] == c and abs(d[1] - s) <= SCORE_ATOL
                                and np.abs(d[2] - box).max() <= BOX_ATOL), None)
                    if hit is None:
                        assert s - convergence_run.SCORE_THRESH <= SCORE_ATOL, (i, c, s)
                        continue
                    free.remove(hit)
                    pairs += 1
    return pairs // 2


def test_convergence_run_held_out_matches_the_jax_script(convergence):
    _, jax_stdout, jax_outs = convergence["jax"]
    res, stdout, port_outs = convergence["port"]
    want = json.loads(jax_stdout.splitlines()[-1])
    got = json.loads(stdout.splitlines()[-1])
    assert list(got) == list(want)
    assert {k: v for k, v in res.items() if k != "log"} == got
    assert len(port_outs) == len(jax_outs) == convergence_run.HELD_OUT_BATCHES
    assert paired(port_outs, jax_outs) > 0
    for k in ("precision@0.5", "recall@0.5"):
        assert got[k] == want[k], k
    assert got["recall@0.5"] > 0


# ------------------------------------------------------------------ data_time
@pytest.mark.parametrize("decoder,pack", [("cv2", False), ("cv2", True), ("png", False),
                                          ("png", True)])
def test_data_time_synthetic_matches_the_jax_script(decoder, pack, monkeypatch):
    """The same batches (shapes and keys) from the same generated dataset
    dicts; the port's PNG path imports no cv2 (its modules' ``cv2`` stay
    unset) and names its decoder."""
    jax_batches = []
    real_loader = jdata.build_detection_train_loader

    def loader(cfg, *a, **k):
        for b in real_loader(cfg, *a, **k):
            jax_batches.append({k: tuple(np.shape(v)) for k, v in b.items()})
            yield b

    monkeypatch.setattr(jdata, "build_detection_train_loader", loader)
    jcatalog.DatasetCatalog.remove("synth_train")     # the JAX script registers it
    argv = ["--config-file", str(FCOS_YAML), "--synthetic", "4", "--workers", "2",
            "--batch", "2", "--iters", "3", "--image-hw", "60", "80"] + (["--pack"] if pack
                                                                       else [])
    jax_stdout = run_jax(monkeypatch, "data_time", argv)
    res, stdout = run_port(data_time.main, argv + ["--decoder", decoder])
    assert res["decoder"] == decoder and data_time.DECODER_NAMES[decoder] in stdout
    assert res["shapes"] == jax_batches[1]          # the first timed batch
    assert res["images"] == 6 and "6 images" in jax_stdout and "img/s" in stdout
    from slenderobjdet_torch.data import mapper, transforms
    assert mapper.cv2 is not None and transforms.cv2 is not None    # restored


@pytest.mark.parametrize("decoder", ["cv2", "png"])
def test_data_time_dataset_dicts_and_stage_rows_match_the_jax_script(decoder, tmp_path,
                                                                     monkeypatch):
    mod = jax_tool("data_time")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = mod._make_synthetic(str(tmp_path / "jax"), 3, (30, 40), False)
    got = data_time._make_synthetic(str(tmp_path / "port"), 3, (30, 40), False, decoder)
    ext = ".png" if decoder == "png" else ".jpg"
    for g, w in zip(got, want):
        assert g["file_name"] == w["file_name"].replace(str(tmp_path / "jax"),
                                                        str(tmp_path / "port"))[:-4] + ext
        assert {k: v for k, v in g.items() if k != "file_name"} == \
            {k: v for k, v in w.items() if k != "file_name"}
    if decoder == "cv2":       # the same JPEG bytes
        for g, w in zip(got, want):
            assert Path(g["file_name"]).read_bytes() == Path(w["file_name"]).read_bytes()
    argv = ["--config-file", str(FCOS_YAML), "--stage-budget", "--iters", "2",
            "--image-hw", "60", "80", "--need-masks"]
    jax_stdout = run_jax(monkeypatch, "data_time", argv)
    res, stdout = run_port(data_time.main, argv + ["--decoder", decoder])
    want_rows = [line.split("  ")[1].strip() for line in jax_stdout.splitlines()
                 if line.endswith("ms/img")]
    if decoder == "png":
        want_rows[0] = "png decode"
    assert [name for name, _ in res["rows"]] == want_rows
    assert len(stdout.splitlines()) == len(jax_stdout.splitlines())


# ----------------------------------------------------------- compare_matchers
def test_compare_matchers_counts_equal_the_jax_script(synth, monkeypatch):
    cfg_file = tiny_yaml(synth["tmp"] / "matchers.yaml", RCNN_YAML, [
        "DATASETS.TEST", f"('{NAME}',)", "INPUT.MIN_SIZE_TEST", 120,
        "INPUT.MAX_SIZE_TEST", 160, "DATALOADER.NUM_WORKERS", 0])
    argv = ["--config-file", cfg_file, "--num-images", "5", "--topk", "4"]
    want = run_jax(monkeypatch, "compare_matchers", argv)
    res, got = run_port(compare_matchers.main, argv + ["--device", "cpu"])
    assert got == want and "over 5 images" in got
    assert res["images"] == 5 and min(res["iou"]) > 0 and min(res["topk"]) > 0


# -------------------------------------------------------------------- readers
def test_result_statistic_equals_the_jax_script(synth, monkeypatch):
    tmp = synth["tmp"]
    argv = ["--prediction", synth["results"], "--gt-json", synth["json"]]
    want = run_jax(monkeypatch, "result_statistic", argv + ["--out", str(tmp / "jax.pkl")])
    res, got = run_port(result_statistic.main, argv + ["--out", str(tmp / "port.pkl")])
    assert got.replace("port.pkl", "jax.pkl") == want
    with open(tmp / "jax.pkl", "rb") as f:
        jax_metrics = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        port_metrics = pickle.load(f)
    assert_nested_close(port_metrics, jax_metrics)
    assert_nested_close(res, jax_metrics)
    assert jax_metrics["bbox"]["AP"] > 10


def test_per_category_table_equals_tabulate():
    """The evaluator's per-category table (``_pipe_table``, no tabulate on
    the card's machine) as the JAX evaluator's ``tabulate`` prints it, on
    seeded names of 1-13 characters and AP values, NaN among them."""
    from tabulate import tabulate

    from slenderobjdet_torch.evaluation.coco_evaluation import _pipe_table

    rs = np.random.RandomState(8)
    for _ in range(200):
        per = [("x" * rs.randint(1, 14), float(rs.choice([np.nan, rs.rand() * 100, 100.0])))
               for _ in range(rs.randint(1, 12))]
        n_cols = min(6, len(per) * 2)
        flat = [v for pair in per for v in pair]
        rows = list(itertools.zip_longest(*[flat[i::n_cols] for i in range(n_cols)]))
        headers = ["category", "AP"] * (n_cols // 2)
        assert _pipe_table(headers, rows) == tabulate(rows, tablefmt="pipe", floatfmt=".3f",
                                                      headers=headers, numalign="left")


@pytest.mark.parametrize("name,argv", [
    ("ar_result", ["--results", "{results}", "--gt-json", "{json}"]),
    ("ar_result", ["--results", "{results}", "--gt-json", "{json}", "--limit", "3"]),
    ("coco_class_info", ["--gt-json", "{json}"]),
    ("coco_class_info", ["--gt-json", "{json}", "--sort-by", "count"]),
    ("data_statistic", ["--gt-json", "{json}"]),
])
def test_readers_print_what_the_jax_scripts_print(synth, name, argv, monkeypatch):
    argv = [a.format(**synth) for a in argv]
    want = run_jax(monkeypatch, name, argv)
    port = {"ar_result": ar_result, "coco_class_info": coco_class_info,
            "data_statistic": data_statistic}[name]
    _, got = run_port(port.main, argv)
    assert got == want and len(got.splitlines()) >= 3


@pytest.mark.parametrize("per_category", [False, True])
def test_regression_prints_what_the_jax_script_prints(synth, per_category, monkeypatch):
    tmp = synth["tmp"]
    jax_tool_argv = ["--prediction", synth["results"], "--gt-json", synth["json"],
                     "--out", str(tmp / "regression.pkl")]
    run_jax(monkeypatch, "result_statistic", jax_tool_argv)
    with open(tmp / "regression.pkl", "rb") as f:
        metrics = pickle.load(f)
    metrics_json = tmp / "evaluate_metrics.json"
    metrics_json.write_text(json.dumps(metrics, default=float))
    argv = ["--metrics", str(metrics_json)] + (
        ["--coco-json", synth["json"], "--stat", "std"] if per_category else [])
    want = run_jax(monkeypatch, "regression", argv)
    res, got = run_port(regression.main, argv)
    assert got == want and "slope" in got and len(res["x"]) >= 2


# ------------------------------------------------------------------ launchers
def test_run_experiments_commands_equal_the_jax_script(monkeypatch):
    for argv in (["--model", "fcos", "--dry-run", "--opts", "SOLVER.MAX_ITER", "20"],
                 ["--model", "retina", "--depths", "18", "34", "--schedule", "2x", "--dry-run"],
                 ["--model", "custom", "--configs", str(FCOS_YAML), "--dry-run"]):
        want = run_jax(monkeypatch, "run_experiments", argv)
        res, got = run_port(run_experiments.main, argv)
        assert got == want.replace(" train_net.py ", " train_net_torch.py ")
        assert [" ".join(c) for c in res["commands"]] == got.splitlines()
        assert all(c[1] == "train_net_torch.py" for c in res["commands"])


def test_run_experiments_retries_as_the_jax_script(monkeypatch):
    """A stub ``subprocess.call`` that fails twice a command, then
    succeeds: with 3 retries every command runs; with 2 the first fails and
    the second succeeds on its first try."""
    argv = ["--model", "custom", "--configs", "a.yaml", "b.yaml", "--retry-wait", "0"]
    outputs = {}
    for retries in ("3", "2"):
        for side in ("jax", "port"):
            calls = []

            def call(cmd):
                calls.append(cmd[1])
                return 1 if len(calls) <= 2 else 0

            monkeypatch.setattr(subprocess, "call", call)
            if side == "jax":
                try:
                    stdout = run_jax(monkeypatch, "run_experiments", argv + ["--retries", retries])
                    code = 0
                except SystemExit as e:
                    stdout, code = "", e.code
                outputs[side, retries] = (calls, code)
            else:
                res, stdout = run_port(run_experiments.main, argv + ["--retries", retries])
                outputs[side, retries] = (calls, 1 if res["failed"] else 0)
                if retries == "2":
                    assert res["failed"] == [" ".join(res["commands"][0])]
    assert outputs["jax", "3"] == (["train_net.py"] * 4, 0)
    assert outputs["port", "3"] == (["train_net_torch.py"] * 4, 0)
    assert outputs["jax", "2"] == (["train_net.py"] * 3, 1)
    assert outputs["port", "2"] == (["train_net_torch.py"] * 3, 1)


def test_watch_evaluate_once_writes_the_marker_and_the_metrics(synth, tmp_path):
    watched = tmp_path / "run" / "coco_instances_results.json"
    watched.parent.mkdir()
    watched.write_text(Path(synth["results"]).read_text())
    argv = ["--watch-dir", str(tmp_path), "--gt-json", synth["json"], "--once"]
    done, stdout = run_port(watch_evaluate.main, argv)
    assert done == [(str(watched), 0)] and "result_statistic" in stdout
    assert (tmp_path / "run" / "coco_instances_results.json.evaluated").read_text() == "ok\n"
    with open(tmp_path / "run" / "coco_instances_results.pkl", "rb") as f:
        metrics = pickle.load(f)
    want, _ = run_port(result_statistic.main, ["--prediction", synth["results"], "--gt-json",
                                               synth["json"], "--out",
                                               str(tmp_path / "direct.pkl")])
    assert_nested_close(metrics, want)
    assert run_port(watch_evaluate.main, argv)[0] == []        # marked: not again


# -------------------------------------------------------------------- imports
def test_port_modules_import_no_jax_and_no_cv2():
    """Every module of the port, and ``chip_smoke.py``, imported in a fresh
    interpreter: no jax, flax or JAX-package module and no cv2 is imported
    (cv2 is taken only at first use, where a file needs it)."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import slenderobjdet_torch
names = sorted(m.name for m in pkgutil.walk_packages(slenderobjdet_torch.__path__,
                                                      'slenderobjdet_torch.'))
for name in names:
    importlib.import_module(name)
import chip_smoke
tools = [n for n in names if n.startswith('slenderobjdet_torch.tools.')]
assert len(tools) >= 38, tools
profilers = ('predict_profile', 'postprocess_probe', 'profile_backbone', 'rcnn_profile',
             'reppoints_profile', 'corner_profile')
assert all('slenderobjdet_torch.tools.' + n in tools for n in profilers), tools
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'slenderobjdet_tpu', 'cv2')]
print(len(names), bad)
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
