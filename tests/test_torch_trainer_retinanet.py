"""The PyTorch port's trainer and its command line on RetinaNet
(``configs/retina/retinanet_R_50_FPN_1x.yaml``) on the CPU, at the tiny size
of ``tests/test_torch_trainer.py``, whose dataset and helpers it shares: 4
steps through ``main`` against the JAX trainer, a resumed run (SGD and
ADAGRAD) bit-equal to an uninterrupted one, and ``--eval-only`` with and
without the anchors."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import flax_to_state_dict  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.engine.train_loop import TrainStep  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.engine import trainer as jtrainer  # noqa: E402
from test_torch_trainer import (MODEL_LOSS_RTOL, NAME, PARAM_RTOL, ROOT,  # noqa: E402,F401
                                cli_args, make_cfg, synth)
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

RETINA_CONFIG = ROOT / "configs/retina/retinanet_R_50_FPN_1x.yaml"
RETINA_TINY = {"MODEL.RETINANET.NUM_CLASSES": 3}


def test_retinanet_main_matches_the_jax_trainer_over_four_steps(synth, monkeypatch):
    """``train_net_torch.main`` on the RetinaNet YAML from the JAX trainer's
    initial weights (carried over as a ``MODEL.WEIGHTS`` checkpoint): the
    same losses a step and the same parameters after 4 steps.

    The LR is 1e-4: with every norm frozen and the backbone random, 1e-2
    sends both trainers to NaN by step 3, and the subnets' pre-activations
    sit so close to 0 (weights of std 0.01, zero biases) that an ulp in a
    parameter can flip a ReLU and move a gradient by a percent. At 1e-4 the
    total loss falls from 4.48 to 2.23 in both."""
    steps = 4
    over = {**RETINA_TINY, "SOLVER.MAX_ITER": steps, "SOLVER.CHECKPOINT_PERIOD": 100,
            "SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 1e-4, "DATASETS.TEST": ()}
    jt = jtrainer.BaseTrainer(make_cfg(jax_get_cfg, synth / "retina_jax", RETINA_CONFIG, **over))
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

    weights = synth / "retina_init.pth"
    torch.save({"model": flax_to_state_dict(variables), "iteration": 0}, weights)
    torch_losses, trainers = [], []
    real_call, real_train = TrainStep.__call__, ttrainer.BaseTrainer.train

    def recording_call(self, batch):
        out = real_call(self, batch)
        torch_losses.append(out)
        return out

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    monkeypatch.setattr(TrainStep, "__call__", recording_call)
    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    train_net_torch.main(cli_args(synth / "retina_torch", "--device", "cpu", config=RETINA_CONFIG,
                                  **over, **{"MODEL.WEIGHTS": str(weights)}))
    model = trainers[0].model
    assert type(model).__name__ == "RetinaNet"
    assert len(torch_losses) == len(jax_losses) == steps
    for i, (g, w) in enumerate(zip(torch_losses, jax_losses)):
        assert sorted(g) == ["loss_box_reg", "loss_cls", "num_pos", "total_loss"]
        for k in g:
            assert float(g[k]) == pytest.approx(float(w[k]), rel=MODEL_LOSS_RTOL), (i, k)
    assert float(torch_losses[0]["num_pos"]) > 1
    assert float(torch_losses[-1]["total_loss"]) < 0.6 * float(torch_losses[0]["total_loss"])
    old = flax_to_state_dict(variables)
    moved = 0
    for name, p in model.named_parameters():
        # the parameter to PARAM_RTOL of its size, or, where it is all
        # update (a bias that started at 0), to 5% of the largest update:
        # a flipped ReLU moves a gradient by about a percent
        want = want_params[name].numpy()
        update = np.abs(want - old[name].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(want).max() + 0.05 * update,
                                   err_msg=name)
        moved += not torch.equal(p.detach(), old[name])
    assert moved > 40
    assert trainers[0].train_step.count == int(jt.state.step) == steps
    records = [json.loads(x) for x in
               (synth / "retina_torch" / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0] and np.isfinite(records[0]["loss_cls"])


def _states_equal(got, want, path=""):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _states_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _states_equal(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("optim", ["SGD", "ADAGRAD"])
def test_retinanet_resumed_run_is_bit_equal_to_the_uninterrupted_run(synth, monkeypatch, optim):
    """RetinaNet through ``main``: 2 iterations and a checkpoint, ``--resume``
    to 4, against a run that went 0 -> 4 on the same batches (the loader
    restarts from its seed on resume). Model, optimizer state (momentum
    buffers or ADAGRAD's sums) and iteration are equal bit for bit."""
    k, n = 2, 4
    over = {**RETINA_TINY, "SOLVER.OPTIM": optim, "SOLVER.BASE_LR": 0.01,
            "SOLVER.WARMUP_ITERS": 3, "SOLVER.CHECKPOINT_PERIOD": 100, "DATASETS.TEST": ()}
    trainers = []
    real_train = ttrainer.BaseTrainer.train

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    out = synth / f"retina_resumed_{optim}"
    train_net_torch.main(cli_args(out, "--device", "cpu", config=RETINA_CONFIG, **over,
                                  **{"SOLVER.MAX_ITER": k}))
    assert (out / "last_checkpoint").read_text() == f"model_{k:07d}"
    train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", config=RETINA_CONFIG,
                                  **over, **{"SOLVER.MAX_ITER": n}))
    assert trainers[1].start_iter == k

    real_loader = ttrainer.build_detection_train_loader

    def restarting_loader(cfg, seed=0):
        def stream():
            head = iter(real_loader(cfg, seed=seed))
            for _ in range(k):
                yield next(head)
            yield from real_loader(cfg, seed=seed)
        return stream()

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", restarting_loader)
    train_net_torch.main(cli_args(synth / f"retina_straight_{optim}", "--device", "cpu",
                                  config=RETINA_CONFIG, **over, **{"SOLVER.MAX_ITER": n}))
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    _states_equal(got, want)
    key = "momentum_buffer" if optim == "SGD" else "sum"
    buffers = [s[key] for s in got["optimizer"]["state"].values()]
    assert len(buffers) > 20 and all(float(b.abs().max()) > 0 for b in buffers)
    _states_equal(trainers[1].checkpointer.load(trainers[1].checkpointer.get_checkpoint_file()),
                  trainers[2].checkpointer.load(trainers[2].checkpointer.get_checkpoint_file()))


@pytest.mark.parametrize("arch", ["RetinaNet", "RetinaNetWithAnchor"])
def test_retinanet_main_evaluates_on_the_cpu(synth, arch):
    """Train 2 steps, then ``--eval-only --resume``: the slender metrics come
    back; a with-anchor model's ``"anchors"`` go no further than the
    evaluator, which reads boxes, scores and classes (as in the JAX trainer)."""
    out = synth / f"retina_eval_{arch}"
    over = {**RETINA_TINY, "MODEL.META_ARCHITECTURE": arch, "SOLVER.MAX_ITER": 2,
            "MODEL.RETINANET.SCORE_THRESH_TEST": 0.0}
    results = train_net_torch.main(cli_args(out, "--device", "cpu", config=RETINA_CONFIG, **over))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            config=RETINA_CONFIG, **over))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"])
    assert json.loads((out / "evaluate_metrics.json").read_text())["ar"].keys() == \
        results[NAME]["ar"].keys()
    dets = json.loads((out / "coco_instances_results.json").read_text())
    assert len(dets) > 0 and set(dets[0]) == {"image_id", "category_id", "bbox", "score"}
