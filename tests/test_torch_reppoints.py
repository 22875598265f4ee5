"""The PyTorch port's RepPoints family held against the JAX package on the
CPU, in float32 at a tiny size (R-18, 64 x 96 images, ``TPU.APPROX_TOPK``
off):

- ``points2bbox`` (minmax, and moment with a given ``moment_transfer``)
  within 1e-6; ``rep_points_assign`` (``pos_num`` 1 and 3) and
  ``inside_assign`` (an image with points inside a box and one without)
  exactly, on integer-pixel boxes that tie;
- ``RepPointsDetector`` with bridged weights: head outputs within 1e-4, each
  loss term within 1e-4, gradients within 1e-3 (max |diff| over max |JAX
  gradient|, per tensor), ``predict`` slot for slot, the three sample modes,
  and two ``TrainStep``s against two JAX train steps with the EMA loss
  normaliser written back;
- the hybrids (``RepPointsCenterness``, ``RepPointsV2``, ``FCOSRepPoints``,
  ``ReppointsRetinaNet``) and the registry's six names are
  ``tests/test_torch_reppoints_variants.py``;
- ``train_net_torch.main --device cpu`` on a tiny RepPoints: train, resume
  bit-equal to an uninterrupted run (the normaliser included), evaluate;
- the d2 import leaving the normaliser alone, and what still raises.

Every input comes from a numpy seed inside its test. The JAX detectors of one
parameter tree share one initialisation a module (``RepPointsDetector``'s
tree serves FCOSRepPoints, RepPointsV2 without the normaliser and
RepPointsCenterness with a ``ctn_out`` drawn here).
"""

import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import reppoints as trep  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.engine.train_loop import TrainState  # noqa: E402
from slenderobjdet_tpu.engine.train_loop import make_train_step as jax_train_step  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import reppoints as jrep  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
RP_CONFIG = ROOT / "configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml"
RPR_CONFIG = ROOT / "configs/group_exp_for_backbone/rep-points/base.yaml"
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)   # per-level head outputs
MODEL_LOSS_RTOL = 1e-4   # tests/test_torch_train.py: whole-model losses
GRAD_TOL = 1e-3          # tests/test_torch_train.py: per tensor, max |diff| / max |JAX gradient|
BOX_TOL = dict(rtol=1e-6, atol=1e-6)


def tiny_cfg(get_cfg, arch="RepPointsDetector", **overrides):
    """R-18, fp32, exact top-k; the FPN and the head keep their 256 channels,
    8 a GroupNorm group: at 64 channels a group of P7's single cell holds 2
    values and the norm amplifies float32 rounding 200-fold in both
    packages."""
    cfg = get_cfg()
    cfg.merge_from_file(str(RPR_CONFIG if arch == "ReppointsRetinaNet" else RP_CONFIG))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def int_boxes(rs, shape, span, lo, hi):
    xy = rs.randint(0, span, (*shape, 2))
    return np.concatenate([xy, xy + rs.randint(lo, hi, (*shape, 2))], -1).astype(np.float32)


def train_batch(seed, batch=2, g=6, hw=(64, 96)):
    """uint8 images and integer-pixel gt boxes of 6-60 pixels, the last rows
    padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": int_boxes(rs, (batch, g), 50, 6, 60),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


def predict_batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([[64, 96], [51, 76]], np.float32)}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------- box coding
@pytest.mark.parametrize("point_stride", [1.0, 4.0, 16.0])
def test_points2bbox_minmax_matches_jax(point_stride):
    rs = np.random.RandomState(1)
    deltas = rs.randn(2, 30, 18).astype(np.float32) * 3
    centers = (rs.randint(0, 20, (30, 2)) * 8).astype(np.float32)
    want = jrep.points2bbox(jnp.asarray(deltas), jnp.asarray(centers), point_stride)
    got = trep.points2bbox(torch.from_numpy(deltas), torch.from_numpy(centers), point_stride)
    assert got.shape == want.shape == (2, 30, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BOX_TOL)


def test_points2bbox_moment_matches_jax():
    """With a given ``moment_transfer``; one row of coincident points keeps a
    finite gradient (the eps inside the sqrt)."""
    rs = np.random.RandomState(2)
    deltas = rs.randn(2, 30, 18).astype(np.float32)
    deltas[0, 0] = 0.5
    centers = (rs.randint(0, 20, (30, 2)) * 8).astype(np.float32)
    mt = np.array([0.3, -0.2], np.float32)
    g = rs.randn(2, 30, 4).astype(np.float32)

    def jf(d, m):
        return jrep.points2bbox(d, jnp.asarray(centers), 2.0, "moment", m)

    want = jf(jnp.asarray(deltas), jnp.asarray(mt))
    jgd, jgm = jax.grad(lambda d, m: jnp.sum(jf(d, m) * g), argnums=(0, 1))(
        jnp.asarray(deltas), jnp.asarray(mt))
    td, tm = torch.tensor(deltas, requires_grad=True), torch.tensor(mt, requires_grad=True)
    got = trep.points2bbox(td, torch.from_numpy(centers), 2.0, "moment", tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    (got * torch.from_numpy(g)).sum().backward()
    assert bool(torch.isfinite(td.grad).all())
    assert ratio(td.grad.numpy(), jgd) <= 1e-5 and ratio(tm.grad.numpy(), jgm) <= 1e-5


# --------------------------------------------------------- assignments
def _point_grid(hw=(256, 384), strides=(8, 16, 32, 64, 128)):
    """Centres (L, 2) at (ix, iy) * stride, levels (L,), strides (L,)."""
    centers, lvls, per_loc = [], [], []
    for s in strides:
        h, w = -(-hw[0] // s), -(-hw[1] // s)
        xg, yg = np.meshgrid(np.arange(w) * s, np.arange(h) * s)
        centers.append(np.stack([xg.ravel(), yg.ravel()], 1))
        lvls.append(np.full(h * w, int(np.log2(s))))
        per_loc.append(np.full(h * w, s))
    return (np.concatenate(centers).astype(np.float32), np.concatenate(lvls).astype(np.int32),
            np.concatenate(per_loc).astype(np.float32))


def _gt_case(seed, g=12):
    """Integer-pixel boxes from 4 to 300 pixels, two of them duplicates (the
    same centre: ties in distance), the last three padding."""
    rs = np.random.RandomState(seed)
    boxes = int_boxes(rs, (g,), 250, 4, 300)
    boxes[3] = boxes[2]
    valid = np.ones(g, bool)
    valid[-3:] = False
    return boxes, valid


@pytest.mark.parametrize("pos_num", [1, 3])
def test_rep_points_assign_equals_jax_exactly(pos_num):
    centers, lvls, _ = _point_grid()
    boxes, valid = _gt_case(20 + pos_num)
    want_obj, want_boxes = jrep.rep_points_assign(
        jnp.asarray(centers), jnp.asarray(lvls), jnp.asarray(boxes), jnp.asarray(valid), 3, 7,
        pos_num=pos_num)
    got_obj, got_boxes = trep.rep_points_assign(
        torch.from_numpy(centers), torch.from_numpy(lvls), torch.from_numpy(boxes),
        torch.from_numpy(valid), 3, 7, pos_num=pos_num)
    np.testing.assert_array_equal(got_obj.numpy(), np.asarray(want_obj))
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(want_boxes))
    assert int(got_obj.sum()) >= pos_num * 6


@pytest.mark.parametrize("inside", [True, False])
def test_inside_assign_equals_jax_exactly(inside):
    """With boxes over the grid some stride cells overlap a box at its level;
    with boxes far off the map none does and the nearest-point assignment
    takes over."""
    centers, lvls, per_loc = _point_grid()
    boxes, valid = _gt_case(25)
    if not inside:
        boxes = boxes + 2000.0
    want_obj, want_boxes = jrep.inside_assign(
        jnp.asarray(centers), jnp.asarray(lvls), jnp.asarray(per_loc), jnp.asarray(boxes),
        jnp.asarray(valid), 3, 7)
    got_obj, got_boxes = trep.inside_assign(
        torch.from_numpy(centers), torch.from_numpy(lvls), torch.from_numpy(per_loc),
        torch.from_numpy(boxes), torch.from_numpy(valid), 3, 7)
    np.testing.assert_array_equal(got_obj.numpy(), np.asarray(want_obj))
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(want_boxes))
    near, _ = trep.rep_points_assign(torch.from_numpy(centers), torch.from_numpy(lvls),
                                     torch.from_numpy(boxes), torch.from_numpy(valid), 3, 7)
    assert torch.equal(got_obj, near) != inside and int(got_obj.sum()) > 0


# --------------------------------------------------------------- weights
def _randomize(variables, seed, cls_std=0.0, cls_bias=None):
    """numpy copy of a Flax tree with FrozenBN buffers away from identity,
    GroupNorm affines away from identity and, for the predict tests, a
    classifier whose scores fall on both sides of the test threshold."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    for node in jax.tree_util.tree_leaves(
            out["buffers"]["backbone"], is_leaf=lambda v: isinstance(v, dict) and "scale" in v):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    head = out["params"]["head"]
    for name, node in head.items():
        if "_gn" in name:
            node["scale"] = rs.uniform(0.8, 1.2, node["scale"].shape).astype(np.float32)
            node["bias"] = (rs.randn(*node["bias"].shape) * 0.1).astype(np.float32)
    if cls_bias is not None:
        head["logits_out"]["kernel"] = (rs.randn(*head["logits_out"]["kernel"].shape)
                                        * cls_std).astype(np.float32)
        head["logits_out"]["bias"][:] = cls_bias
    return out


@pytest.fixture(scope="module")
def rp_variables():
    """RepPointsDetector's tree (FrozenBN and GN drawn away from identity)."""
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    return _randomize(det.init_variables(jax.random.PRNGKey(0)), seed=30)


def variables_for(arch, variables):
    """The RepPointsDetector tree adapted to ``arch``'s."""
    out = jax.tree_util.tree_map(np.array, variables)
    if arch == "RepPointsV2":
        del out["buffers"]["loss_normalizer"]
    if arch == "RepPointsCenterness":
        rs = np.random.RandomState(31)
        out["params"]["head"]["ctn_out"] = {
            "kernel": (rs.randn(1, 1, 256, 1) * 0.05).astype(np.float32),
            "bias": np.zeros(1, np.float32)}
    return out


def port_model(arch, variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def test_bridge_carries_the_reppoints_tree(rp_variables):
    leaves = jax.tree_util.tree_leaves(rp_variables)
    sd = flax_to_state_dict(rp_variables)
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    assert len(sd) == len(leaves) == len(model.state_dict())
    assert sd["head.deform_cls_conv.weight"].shape == (9, 256, 256)
    assert sd["head.cls_gn2.weight"].shape == (256,)
    assert float(sd["loss_normalizer"]) == 20.0
    load_flax_variables(model, rp_variables)
    np.testing.assert_array_equal(model.head.deform_reg_conv.weight.detach().numpy(),
                                  rp_variables["params"]["head"]["deform_reg_conv"]["weight"])
    np.testing.assert_array_equal(model.head.reg_gn1.weight.detach().numpy(),
                                  rp_variables["params"]["head"]["reg_gn1"]["scale"])
    assert float(model.loss_normalizer) == 20.0
    bad = {"buffers": {**rp_variables["buffers"], "loss_scale": np.float32(1)}}
    with pytest.raises(KeyError):
        load_flax_variables(model, {**rp_variables, **bad})


def test_head_outputs_match_jax(rp_variables):
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    model = port_model("RepPointsDetector", rp_variables)
    images = train_batch(32)["image"]
    jvars = jax.tree_util.tree_map(jnp.asarray, rp_variables)
    want = jax.jit(det.module.apply)(det._module_variables(jvars), jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    cells = [8 * 12, 4 * 6, 2 * 3, 1 * 2, 1 * 1]
    for part, (g_l, w_l) in enumerate(zip(got, want)):
        for lvl in range(5):
            width = 80 if part == 0 else 18
            assert tuple(g_l[lvl].shape) == w_l[lvl].shape == (2, cells[lvl], width)
            np.testing.assert_allclose(g_l[lvl].numpy(), np.asarray(w_l[lvl]), **HEAD_TOL)
    # a random head already places fractional points
    frac = np.asarray(want[1][0]) % 1
    assert ((frac > 0.01) & (frac < 0.99)).mean() > 0.5


@pytest.fixture(scope="module")
def jax_loss(rp_variables):
    """The JAX loss, metrics and gradients on one batch."""
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    jvars = jax.tree_util.tree_map(jnp.asarray, rp_variables)
    batch = train_batch(33)

    def loss_fn(params):
        return det.loss({"params": params, "buffers": jvars["buffers"]}, jnp_batch(batch))

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jvars["params"])
    return {"batch": batch, "total": float(total),
            "metrics": {k: float(v) for k, v in metrics.items() if not k.startswith("_")},
            "grads": flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})}


def test_loss_terms_match_jax(rp_variables, jax_loss):
    model = port_model("RepPointsDetector", rp_variables)
    total, metrics = model.loss(jax_loss["batch"])
    want = jax_loss["metrics"]
    assert sorted(metrics) == sorted(want) == [
        "loss_cls", "loss_localization_init", "loss_localization_refine", "loss_normalizer",
        "num_pos"]
    assert float(total.detach()) == pytest.approx(jax_loss["total"], rel=MODEL_LOSS_RTOL)
    for k, v in want.items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=MODEL_LOSS_RTOL), k
    assert float(metrics["num_pos"]) > 4 and float(metrics["loss_localization_refine"]) > 0
    # the EMA was updated before use, and loss wrote nothing back
    assert float(metrics["loss_normalizer"]) == pytest.approx(
        0.9 * 20 + 0.1 * float(metrics["num_pos"]) / 2, rel=1e-6)
    assert float(model.loss_normalizer) == 20.0


def test_gradients_match_jax(rp_variables, jax_loss):
    cfg = tiny_cfg(torch_get_cfg)
    model = port_model("RepPointsDetector", rp_variables)
    tsolver.build_optimizer(cfg, model)           # applies FREEZE_AT
    total, _ = model.loss(jax_loss["batch"])
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        assert ratio(p.grad.numpy(), jax_loss["grads"][name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"head.deform_cls_conv.weight", "head.deform_reg_conv.bias",
            "head.offsets_init_out.weight", "head.offsets_refine_out.weight",
            "head.cls_gn0.weight", "head.logits_out.bias",
            "backbone.bottom_up.res4_0.conv1.weight"} <= checked
    # offsets_init learns through the boxes and the gradient_mul blend
    assert float(model.head.offsets_init_out.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("mode", ["nearest_points", "inside"])
def test_sample_modes_match_jax(mode, rp_variables):
    over = {"MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE": mode}
    det = jax_build_model(tiny_cfg(jax_get_cfg, **over))
    batch = train_batch(34)
    total, metrics = jax.jit(det.loss)(jax.tree_util.tree_map(jnp.asarray, rp_variables),
                                       jnp_batch(batch))
    model = port_model("RepPointsDetector", rp_variables, **over)
    got, got_metrics = model.loss(batch)
    assert model.sample_mode == mode
    assert float(got.detach()) == pytest.approx(float(total), rel=MODEL_LOSS_RTOL)
    assert float(got_metrics["loss_localization_init"].detach()) == pytest.approx(
        float(metrics["loss_localization_init"]), rel=MODEL_LOSS_RTOL)


def assert_detections_equal(got, want):
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    assert got["classes"].dtype == torch.int32 and got["valid"].dtype == torch.bool
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    assert tuple(got["boxes"].shape) == want["boxes"].shape == (2, 100, 4)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid], rtol=0,
                               atol=1e-3)


PREDICT_CLS = dict(cls_std=0.15, cls_bias=-4.6)   # a few dozen scores over 0.05 an image


def _predict_pair(arch, variables, seed):
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    assert not det.approx_topk
    model = port_model(arch, variables)
    batch = predict_batch(seed)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                jnp_batch(batch))
    return model.predict(batch), {k: np.asarray(v) for k, v in want.items()}


def test_predict_matches_jax(rp_variables):
    variables = _randomize(rp_variables, seed=35, **PREDICT_CLS)
    got, want = _predict_pair("RepPointsDetector", variables, 36)
    per_image = want["valid"].sum(1)
    assert (per_image >= 5).all() and (per_image < 100).all(), per_image
    assert_detections_equal(got, want)
    b = got["boxes"].numpy()[1][want["valid"][1]]
    assert b.min() >= 0 and b[:, 0::2].max() <= 76 and b[:, 1::2].max() <= 51


def test_two_train_steps_match_jax(rp_variables):
    """Two ``TrainStep`` updates (SGD, momentum, weight decay) against two of
    the JAX package's train step: the losses, the normaliser written back
    after each step, and every parameter after the second."""
    over = {"SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.01}
    jcfg, cfg = tiny_cfg(jax_get_cfg, **over), tiny_cfg(torch_get_cfg, **over)
    det = jax_build_model(jcfg)
    batches = [train_batch(37), train_batch(38)]
    jvars = jax.tree_util.tree_map(jnp.asarray, rp_variables)
    tx = jsolver.build_optimizer(jcfg, jvars["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                       buffers=jvars["buffers"], opt_state=tx.init(jvars["params"]))
    step = jax_train_step(det, tx, donate=False)
    want = []
    for b in batches:
        state, m = step(state, jnp_batch(b))
        want.append((float(m["total_loss"]), float(state.buffers["loss_normalizer"])))
    want_params = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                                        state.params)})

    model = port_model("RepPointsDetector", rp_variables, **over)
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    tstep = make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)
    for b, (loss, normalizer) in zip(batches, want):
        metrics = tstep(b)
        assert float(metrics["total_loss"]) == pytest.approx(loss, rel=MODEL_LOSS_RTOL)
        assert float(model.loss_normalizer) == pytest.approx(normalizer, rel=1e-6)
    assert float(model.loss_normalizer) < 20.0
    for name, p in model.named_parameters():
        delta = (p.detach() - old[name]).numpy()
        want_delta = want_params[name].numpy() - old[name].numpy()
        if tsolver.frozen(cfg, name):
            assert not delta.any(), name
            continue
        ulp = np.spacing(np.abs(old[name].numpy()).max())
        np.testing.assert_allclose(delta, want_delta, rtol=0,
                                   atol=1e-2 * np.abs(want_delta).max() + 2 * ulp, err_msg=name)


def test_moment_transform_raises_at_construction():
    cfg = tiny_cfg(torch_get_cfg, **{"MODEL.REPPOINTS.TRANSFORM_METHOD": "moment"})
    with pytest.raises(NotImplementedError, match="moment_transfer"):
        torch_build_model(cfg, device="cpu")
    # ReppointsRetinaNet decodes with minmax whatever the key says
    cfg = tiny_cfg(torch_get_cfg, "ReppointsRetinaNet",
                   **{"MODEL.REPPOINTS.TRANSFORM_METHOD": "moment"})
    assert torch_build_model(cfg, device="cpu").transform_method == "minmax"


@pytest.mark.parametrize("arch", ["NoSuchArch", "CenterNet"])
def test_unported_names_still_raise(arch):
    with pytest.raises(KeyError, match="RepPointsV2"):
        torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")


def test_d2_import_leaves_the_normaliser_at_its_initial_value(tmp_path):
    """A d2 zoo file fills the backbone (here the stem and one block's conv1
    with its BatchNorm statistics) and leaves the normaliser as it was."""
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    with torch.no_grad():
        model.loss_normalizer.fill_(7.0)      # a trained value; the import touches no head
    rs = np.random.RandomState(47)
    conv1 = model.backbone.bottom_up.res3_0.conv1.weight
    sd = {"backbone.bottom_up.stem.conv1.weight": rs.randn(64, 3, 7, 7),
          "backbone.bottom_up.res3.0.conv1.weight": rs.randn(*conv1.shape)}
    for leaf, v in (("weight", rs.rand(128) + 0.5), ("bias", rs.randn(128)),
                    ("running_mean", rs.randn(128)), ("running_var", rs.rand(128) + 0.1)):
        sd[f"backbone.bottom_up.res3.0.conv1.norm.{leaf}"] = v
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    pkl = tmp_path / "R-XX.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd}, f)
    before = model.backbone.bottom_up.res3_0.conv1.weight.detach().clone()
    tckpt.load_model_weights(str(pkl), model)
    assert float(model.loss_normalizer) == 7.0
    assert not torch.equal(model.backbone.bottom_up.res3_0.conv1.weight, before)
    fresh = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    tckpt.load_model_weights(str(pkl), fresh)
    assert float(fresh.loss_normalizer) == 20.0


# ---------------------------------------------------------- the entry point
NAME = "torch_reppoints_synth"
TINY_MAIN = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.RETINANET.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.BASE_LR": 0.01,
    "SOLVER.WARMUP_ITERS": 3, "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_reppoints")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    tcatalog.DatasetCatalog.remove(NAME)
    tcoco.register_coco_instances(NAME, path, root)
    return tmp


def cli_args(out, *flags, **overrides):
    opts = {**TINY_MAIN, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(RP_CONFIG), *flags] + [str(x) for kv in opts.items() for x in kv])


def test_main_trains_resumes_bit_equal_and_evaluates(synth, monkeypatch):
    """1 iteration and a checkpoint, ``--resume`` to 2, against a run that
    went 0 -> 2 on the same batches (the loader restarts from its seed on
    resume): model (the EMA normaliser included), momentum and iteration equal
    bit for bit; then ``--eval-only``."""
    k, n = 1, 2
    trainers = []
    real_train = ttrainer.BaseTrainer.train

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    out = synth / "resumed"
    train_net_torch.main(cli_args(out, "--device", "cpu", **{"SOLVER.MAX_ITER": k,
                                                             "DATASETS.TEST": ()}))
    saved = torch.load(out / f"model_{k:07d}.pth", weights_only=True)
    assert 0 < float(saved["model"]["loss_normalizer"]) < 20.0
    train_net_torch.main(cli_args(out, "--device", "cpu", "--resume",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
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
    train_net_torch.main(cli_args(synth / "straight", "--device", "cpu",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    assert sorted(got["model"]) == sorted(want["model"])
    for key in got["model"]:
        assert torch.equal(got["model"][key], want["model"][key]), key
    assert float(got["model"]["loss_normalizer"]) != float(saved["model"]["loss_normalizer"])
    for s_got, s_want in zip(got["optimizer"]["state"].values(),
                             want["optimizer"]["state"].values()):
        assert torch.equal(s_got["momentum_buffer"], s_want["momentum_buffer"])
    with open(out / "metrics.json") as f:
        logged = [json.loads(line) for line in f]
    assert "loss_localization_refine" in logged[0] and "loss_normalizer" in logged[0]

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", real_loader)
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **{"SOLVER.MAX_ITER": n}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]
