"""The PyTorch port's trainer and its command line on the CPU, at a tiny
size (R-18, 64-pixel images, float32):

- the JAX package's ``BaseTrainer`` and the port's, from the same weights
  (carried over by ``checkpoint/bridge.py``) on the same synthetic dataset,
  give per-step losses and final parameters within the tolerances that
  ``tests/test_torch_train.py`` states for one step, over 4 steps;
- ``train_net_torch.main`` trains, resumes and evaluates with
  ``--device cpu``, and fails without a card when no device is named
  (RetinaNet's trainer tests are ``tests/test_torch_trainer_retinanet.py``);
- ``--eval-only`` with test-time augmentation (``TEST.AUG.ENABLED``);
- what is not ported raises, metrics are fetched on logging iterations only,
  the profiler window writes its trace, and no file of the port imports JAX
  or the JAX package.
"""

import json
import os
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

import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.engine.train_loop import TrainStep  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402
from slenderobjdet_tpu.engine import trainer as jtrainer  # noqa: E402
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
NAME = "torch_trainer_synth"
MODEL_LOSS_RTOL = 1e-4    # tests/test_torch_train.py: whole-model losses
PARAM_RTOL = 1e-5         # tests/test_torch_train.py: parameters after a step

TINY = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.FCOS.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_trainer")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    return tmp


def make_cfg(get_cfg, out, config=CONFIG, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(config))
    opts = {**TINY, "OUTPUT_DIR": str(out), **overrides}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def cli_args(out, *flags, config=CONFIG, **overrides):
    opts = {**TINY, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(config), *flags]
        + [str(x) for kv in opts.items() for x in kv])


# ------------------------------------------------- (d) against the JAX trainer
@pytest.mark.usefixtures("default_torch_threads")   # one thread moves it past its tolerance
def test_trainer_matches_the_jax_trainer_over_four_steps(synth, monkeypatch):
    steps = 4
    over = {"SOLVER.MAX_ITER": steps, "SOLVER.CHECKPOINT_PERIOD": 100,
            "SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.01}
    jt = jtrainer.BaseTrainer(make_cfg(jax_get_cfg, synth / "jax_out", **over))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get({"params": jt.state.params, "buffers": jt.state.buffers}))
    jax_losses = []
    jax_step = jt.train_step

    def recording_jax_step(state, batch):
        state, metrics = jax_step(state, batch)
        jax_losses.append(metrics)
        return state, metrics

    jt.train_step = recording_jax_step
    jt.train()
    want_params = flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.params))})

    pt = ttrainer.BaseTrainer(make_cfg(torch_get_cfg, synth / "torch_out", **over),
                              device="cpu")
    load_flax_variables(pt.model, variables)
    old = {k: v.detach().clone() for k, v in pt.model.named_parameters()}
    torch_losses = []
    real_call = TrainStep.__call__

    def recording_call(self, batch):
        out = real_call(self, batch)
        torch_losses.append(out)
        return out

    monkeypatch.setattr(TrainStep, "__call__", recording_call)
    pt.train()

    assert len(torch_losses) == len(jax_losses) == steps
    for i, (g, w) in enumerate(zip(torch_losses, jax_losses)):
        for k in ("total_loss", "cls_loss", "reg_loss", "centerness_loss", "num_pos"):
            assert float(g[k]) == pytest.approx(float(w[k]), rel=MODEL_LOSS_RTOL), (i, k)
    assert float(torch_losses[0]["num_pos"]) > 1
    moved = 0
    for name, p in pt.model.named_parameters():
        want = want_params[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(want).max(), err_msg=name)
        moved += not torch.equal(p.detach(), old[name])
    assert moved > 40 and pt.train_step.count == int(jt.state.step) == steps


# ---------------------------------------------------------- (e) the entry point
def test_main_trains_resumes_and_evaluates_on_the_cpu(synth):
    out = synth / "cli_out"
    over = {"SOLVER.CHECKPOINT_PERIOD": 2, "MODEL.FCOS.INFERENCE_TH": 0.0}
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--num-gpus", "8",
                                            **over, **{"SOLVER.MAX_ITER": 4}))
    assert sorted(p.name for p in out.glob("model_*")) == ["model_0000002.pth",
                                                           "model_0000004.pth"]
    assert (out / "last_checkpoint").read_text() == "model_0000004"
    assert (out / "config.yaml").exists()
    records = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    # metrics are fetched on logging iterations only: the first, then every 20th
    assert [r["iteration"] for r in records] == [0]
    assert np.isfinite(records[0]["total_loss"]) and records[0]["data_time"] >= 0
    bbox = results[NAME]["bbox"]
    assert set(STATS_NAMES) <= set(bbox) and "AR@100" in results[NAME]["ar"]
    assert results[NAME]["_timing"]["images"] >= 0

    # --resume goes on from iteration 4 to 6 with the saved state
    trainer_holder = []
    real_train = ttrainer.BaseTrainer.train

    def recording_train(self):
        trainer_holder.append((self.start_iter, self.train_step.count))
        return real_train(self)

    ttrainer.BaseTrainer.train = recording_train
    try:
        train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", **over,
                                      **{"SOLVER.MAX_ITER": 6, "DATASETS.TEST": ()}))
    finally:
        ttrainer.BaseTrainer.train = real_train
    assert trainer_holder == [(4, 4)]
    assert (out / "last_checkpoint").read_text() == "model_0000006"
    records = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 4]

    # --eval-only --resume evaluates the last checkpoint
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **over, **{"SOLVER.MAX_ITER": 6}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"])
    assert json.loads((out / "evaluate_metrics.json").read_text())["ar"].keys() == \
        results[NAME]["ar"].keys()


def test_main_fails_without_a_card_unless_the_cpu_is_asked_for(synth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net_torch.main(cli_args(synth / "no_card", **{"SOLVER.MAX_ITER": 1}))
    args = cli_args(synth / "no_card")
    assert args.device is None and not args.resume and not args.eval_only
    assert train_net_torch.setup(args).OUTPUT_DIR == str(synth / "no_card")


# ------------------------------------------------------- options and windows
@pytest.mark.parametrize("overrides,match", [
    pytest.param({"MODEL.META_ARCHITECTURE": "RepPointsDetector",
                  "MODEL.REPPOINTS.TRANSFORM_METHOD": "moment"}, "moment_transfer",
                 id="overrides1-moment_transfer"),
])
def test_unported_trainer_options_raise(synth, overrides, match):
    cfg = make_cfg(torch_get_cfg, synth / "unported", **{"SOLVER.MAX_ITER": 1}, **overrides)
    with pytest.raises(NotImplementedError, match=match):
        trainer = ttrainer.BaseTrainer(cfg, device="cpu")
        trainer.train()
        trainer.test()


def test_rotated_evaluator_type_raises(synth):
    """An "rcoco" dataset is evaluated by the rotated evaluator, which takes
    XYWHA detections: an axis-aligned detector's raise."""
    cfg = make_cfg(torch_get_cfg, synth / "unported", **{"SOLVER.MAX_ITER": 1})
    trainer = ttrainer.BaseTrainer(cfg, device="cpu")
    meta = tcatalog.MetadataCatalog.get(NAME)
    meta.set(evaluator_type="rcoco")
    try:
        with pytest.raises(ValueError, match="rcoco evaluator takes rotated"):
            trainer.test()
    finally:
        meta.set(evaluator_type="coco")


TTA = {"TEST.AUG.ENABLED": True, "TEST.AUG.MIN_SIZES": (48, 64), "TEST.AUG.MAX_SIZE": 128,
       "TEST.AUG.FLIP": True, "MODEL.FCOS.INFERENCE_TH": 0.0}


def test_main_eval_only_with_tta_on_the_cpu(synth, monkeypatch):
    """``TEST.AUG.ENABLED`` routes ``--eval-only`` through ``tta_predict``,
    one call an image, into the evaluator (the JAX trainer's
    ``test_eval_with_tta``); an "rcoco" dataset keeps the plain loader path,
    as in the JAX trainer."""
    seen = []
    real = ttrainer.tta_predict

    def recording(model, d, cfg, predict_fns=None):
        seen.append(d["image_id"])
        return real(model, d, cfg, predict_fns=predict_fns)

    monkeypatch.setattr(ttrainer, "tta_predict", recording)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # 24 small predicts: one thread, under six workers
    try:
        results = train_net_torch.main(cli_args(synth / "tta_out", "--device", "cpu",
                                                "--eval-only", **TTA))
    finally:
        torch.set_num_threads(threads)
    assert sorted(seen) == list(range(1, 7))
    bbox = results[NAME]["bbox"]
    assert set(STATS_NAMES) <= set(bbox) and np.isfinite(bbox["AP"])
    assert "AR@100" in results[NAME]["ar"]
    cfg = make_cfg(torch_get_cfg, synth / "tta_out", **TTA)
    trainer = ttrainer.BaseTrainer(cfg, device="cpu")
    meta = tcatalog.MetadataCatalog.get(NAME)
    meta.set(evaluator_type="rcoco")
    try:
        with pytest.raises(ValueError, match="rcoco evaluator takes rotated"):
            trainer.test()
    finally:
        meta.set(evaluator_type="coco")
    assert len(seen) == 6


def test_profile_window_writes_a_trace(synth):
    out = synth / "profile_out"
    cfg = make_cfg(torch_get_cfg, out, **{
        "SOLVER.MAX_ITER": 3, "TPU.PROFILE_START_ITER": 1, "TPU.PROFILE_NUM_ITERS": 1,
        "DATASETS.TEST": ()})
    ttrainer.default_setup(cfg)
    trainer = ttrainer.BaseTrainer(cfg, device="cpu")
    trainer.train()
    trace = json.loads((out / "profile" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 10
    assert (out / "config.yaml").read_text() == cfg.dump()


# ------------------------------------------------------------- boundaries
def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|slenderobjdet_tpu)\b",
                         re.M)
    files = [*ROOT.glob("slenderobjdet_torch/**/*.py"), ROOT / "chip_smoke.py",
             ROOT / "train_net_torch.py"]
    assert len(files) > 40
    bad = {str(f.relative_to(ROOT)): pattern.findall(f.read_text()) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_trainer_modules_load_without_jax():
    """A fresh interpreter that imports the entry point, the trainer, the
    loaders (the map renderer, packs, object-storage paths and Objects365
    among them), the evaluator and the checkpointer holds no jax module."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import train_net_torch
from slenderobjdet_torch.engine import trainer
from slenderobjdet_torch.checkpoint import checkpointer
from slenderobjdet_torch import data, evaluation
from slenderobjdet_torch.data import recordpack
from slenderobjdet_torch.data.datasets import objects365
from slenderobjdet_torch.structures import borders, native
from slenderobjdet_torch.tools import coco_to_pack
from slenderobjdet_torch.utils import smart_path
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'slenderobjdet_tpu')]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
