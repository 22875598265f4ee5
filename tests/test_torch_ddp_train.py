"""Data-parallel training of the PyTorch port on the CPU: two gloo ranks
(``parallel.launch``, ``tests/ddp_workers.py``) take ``TrainStep``s through
DDP on the halves of a joined batch of 4 images whose halves hold unequal
numbers of objects (1 gt an image in one, 5 in the other), at the tiny size
of the single-process parity tests (R-18, 64 x 64, float32).

For FCOS, RetinaNet, RepPoints and the ablation chassis on
``pointset_sup.yaml`` (a per-image-mean normaliser), each 2 steps:

- the parameters are bit-equal across the ranks;
- they are within 1e-5 of the single-process port's 2 steps on the joined
  batches (per tensor, max |diff| over 1e-5 of its largest value plus 1e-2
  of its largest update), and the mean of the ranks' losses a step is the
  single process's loss;
- RepPoints' EMA ``loss_normalizer`` is equal on both ranks and to the
  single process's;
- FCOS's step-1 parameters and loss are within 1e-5 of the JAX train step
  on the joined batch (weights through ``checkpoint/bridge.py``).

A rank that divided by its own half's counts would fail each of these: the
halves' counts differ. Faster R-CNN takes one step on two ranks, each
drawing its own subsampling: finite losses, parameters bit-equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import ddp_workers  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.parallel import launch  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402
from test_torch_train import jax_cfg  # noqa: E402

PARAM_RTOL = 1e-5    # parameters after a step, per tensor, relative to its largest
UPDATE_RTOL = 1e-2   # and to its largest update (tests/test_torch_train.py: the update to 1e-2)
LOSS_RTOL = 1e-5     # the joined batch's total loss
TINY = {"MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32"}
EXACT_TOPK = {**TINY, "TPU.APPROX_TOPK": False}
FAMILIES = {
    "FCOS": ("configs/fcos/fcos_R_50_FPN_1x.yaml", TINY),
    "RetinaNet": ("configs/retina/retinanet_R_50_FPN_1x.yaml", TINY),
    "RepPoints": ("configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml", EXACT_TOPK),
    "pointset_sup": ("configs/ablation_studies/pointset_sup.yaml", EXACT_TOPK),
}
RCNN = ("configs/faster/faster_rcnn_R_50_FPN_1x.yaml",
        {**TINY, "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100})


def joined_batch(seed, counts, g=6, hw=(64, 64)):
    """uint8 images and integer-pixel gt boxes of 12-48 pixels, ``counts[b]``
    valid boxes in image b, the rest padding."""
    rs = np.random.RandomState(seed)
    n = len(counts)
    boxes = np.zeros((n, g, 4), np.float32)
    valid = np.zeros((n, g), bool)
    for b, k in enumerate(counts):
        xy = rs.randint(0, 30, (k, 2))
        boxes[b, :k] = np.concatenate([xy, np.minimum(xy + rs.randint(12, 48, (k, 2)),
                                                      (hw[1], hw[0]))], 1)
        valid[b, :k] = True
    return {"image": rs.randint(0, 256, (n, *hw, 3)).astype(np.uint8), "gt_boxes": boxes,
            "gt_classes": rs.randint(0, 80, (n, g)).astype(np.int32), "gt_valid": valid}


# steps 1 and 2: the larger half on rank 1, then on rank 0
BATCHES = [joined_batch(21, (1, 1, 5, 5)), joined_batch(22, (5, 5, 1, 1))]


def jax_fcos_step(batch):
    """The JAX tiny flagship's initial variables, and its first train step
    on ``batch``: total loss, metrics and the new parameters."""
    cfg = jax_cfg()
    det = jax_build_model(cfg)
    variables = det.init_variables(jax.random.PRNGKey(0), (64, 64), 2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        return det.loss({"params": params, "buffers": variables["buffers"]}, jbatch)

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    tx = jsolver.build_optimizer(cfg, variables["params"])
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    return (jax.tree_util.tree_map(np.asarray, variables), float(total),
            {k: float(v) for k, v in metrics.items()},
            flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, new_params)}))


def single_process(spec):
    """The port's steps of ``spec`` on the joined batches in this process,
    at the ranks' thread count: per step the metrics, the model at the end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(ddp_workers.THREADS)
    try:
        model, step = ddp_workers.build_family(spec)
        metrics = [{k: float(v) for k, v in step(dict(b)).items()}
                   for b in BATCHES[:spec["steps"]]]
    finally:
        torch.set_num_threads(threads)
    return metrics, model


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The single-process references, then one spawn of two gloo ranks that
    runs every family."""
    tmp = tmp_path_factory.mktemp("ddp_train")
    variables, jax_total, jax_metrics, jax_new = jax_fcos_step(BATCHES[0])
    fcos_weights = tmp / "fcos_init.pt"
    model, _ = ddp_workers.build_family({"yaml": FAMILIES["FCOS"][0],
                                         "overrides": FAMILIES["FCOS"][1], "seed": 0})
    load_flax_variables(model, variables)
    torch.save(model.state_dict(), fcos_weights)
    torch.save(jax_new, tmp / "fcos_jax_step1.pt")

    specs, single = {}, {}
    for seed, (name, (yaml, over)) in enumerate(FAMILIES.items()):
        spec = {"yaml": yaml, "overrides": over, "seed": seed, "steps": 2,
                "tol": (PARAM_RTOL, UPDATE_RTOL),
                "weights": str(fcos_weights) if name == "FCOS" else None}
        metrics, model = single_process(spec)
        torch.save(model.state_dict(), tmp / f"{name}_single.pt")
        spec["refs"] = {2: str(tmp / f"{name}_single.pt")}
        if name == "FCOS":
            spec["refs"][1] = str(tmp / "fcos_jax_step1.pt")
        specs[name] = spec
        single[name] = (metrics, getattr(model, "loss_normalizer", None))
    specs["FasterRCNN"] = {"yaml": RCNN[0], "overrides": RCNN[1], "seed": 7, "steps": 1}
    ranks = launch(ddp_workers.run_families, 2, args=(specs, BATCHES), backend="gloo",
                   timeout=ddp_workers.GROUP_TIMEOUT, join_timeout=ddp_workers.JOIN_TIMEOUT)
    return {"ranks": ranks, "single": single, "jax": (jax_total, jax_metrics)}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_ranks_equal_each_other_and_the_joined_batch_step(ddp_run, name):
    r0, r1 = (r[name] for r in ddp_run["ranks"])
    assert r0["digest"] == r1["digest"]
    assert r0["excess"][2] <= 1 and r1["excess"][2] <= 1
    # each rank's loss is its share of the joined batch's: their mean is it
    single_metrics, _ = ddp_run["single"][name]
    for i, want in enumerate(single_metrics):
        got = (r0["metrics"][i]["total_loss"] + r1["metrics"][i]["total_loss"]) / 2
        assert got == pytest.approx(want["total_loss"], rel=LOSS_RTOL), i
        assert r0["metrics"][i]["num_pos"] == r1["metrics"][i]["num_pos"] == want["num_pos"]


def test_reppoints_normalizer_is_global(ddp_run):
    _, want = ddp_run["single"]["RepPoints"]
    r0, r1 = (r["RepPoints"] for r in ddp_run["ranks"])
    assert r0["loss_normalizer"] == r1["loss_normalizer"] == float(want)
    assert float(want) != 20.0       # it moved off its initial value


def test_fcos_ranks_take_the_jax_step_on_the_joined_batch(ddp_run):
    jax_total, jax_metrics = ddp_run["jax"]
    r0, r1 = (r["FCOS"] for r in ddp_run["ranks"])
    assert r0["excess"][1] <= 1 and r1["excess"][1] <= 1
    total = (r0["metrics"][0]["total_loss"] + r1["metrics"][0]["total_loss"]) / 2
    assert total == pytest.approx(jax_total, rel=LOSS_RTOL)
    assert r0["metrics"][0]["num_pos"] == jax_metrics["num_pos"] > 1


def test_faster_rcnn_steps_on_two_ranks(ddp_run):
    r0, r1 = (r["FasterRCNN"] for r in ddp_run["ranks"])
    assert r0["digest"] == r1["digest"]
    for r in (r0, r1):
        assert all(np.isfinite(v) for v in r["metrics"][0].values())
