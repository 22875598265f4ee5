"""The PyTorch port's two diagnosis detectors built from the FCOS parts,
held against the JAX package on the CPU in float32 at a tiny size (R-18,
64 x 96 images, ``TPU.APPROX_TOPK`` off, the FPN and the heads 256 wide):

- the top-k-per-gt gate exactly against the JAX expression (a gt with fewer
  than 5 positives lets none through), and ``FCOSTopK``'s loss within 1e-4;
- ``FCOSAnchor`` with 3 anchors a location (the softmax over a location's
  anchors has something to decide): its anchor offsets exactly, head
  outputs within 1e-4, each loss term within 1e-4, gradients within 1e-3,
  ``predict`` slot for slot; the yaml (one anchor a location) at full
  width.

Every input comes from a numpy seed inside its test; the parameter trees
are drawn in numpy and the head outputs read from the loss's own forward, as
in ``tests/test_torch_ablation.py``.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.checkpoint.bridge import flax_to_state_dict, load_flax_variables  # noqa: E402
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import fcos as tfcos  # noqa: E402
from slenderobjdet_torch.models.meta_arch import fcos_anchor as tfa  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import fcos_anchor as jfa  # noqa: E402
from test_torch_ablation import Capture, draw_variables, one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TOPK_CONFIG = ROOT / "configs/fcos/fcos_topk_R_50_FPN_1x.yaml"
ANCHOR_CONFIG = ROOT / "configs/fcos_anchor/fcos_anchor_R_50_FPN_1x.yaml"
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)   # per-level head outputs
MODEL_LOSS_RTOL = 1e-4   # tests/test_torch_train.py: whole-model losses
GRAD_TOL = 1e-3          # tests/test_torch_train.py: per tensor, max |diff| / max |JAX gradient|
THREE_ANCHORS = {"MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[0.5, 1.0, 2.0]]}
# the centerness and shape convs spread, so that the softmaxes over a
# location's anchors and the score gate are not flat
FA_CONVS = {"centerness": (0.03, 0.0), "shape_cls": (0.03, 0.0)}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny_cfg(get_cfg, config, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(config))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def train_batch(seed, batch=2, g=6, hw=(64, 96)):
    """uint8 images and integer-pixel gt boxes of 6-60 pixels, the last two
    rows padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    xy = rs.randint(0, 50, (batch, g, 2))
    boxes = np.concatenate([xy, xy + rs.randint(6, 60, (batch, g, 2))], -1)
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": boxes.astype(np.float32),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_model(config, variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, config, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


# ------------------------------------------------------------- FCOSTopK
def jax_gate(ctr_targets, pos, gt_inds, G, k):
    """``slenderobjdet_tpu/models/meta_arch/fcos.py:405-420``, word for
    word (the JAX package has it inline in ``FCOS.loss``)."""
    per_gt = jax.nn.one_hot(gt_inds, G, dtype=jnp.float32) * pos[..., None]
    scores = jnp.where(per_gt > 0, ctr_targets[..., None], -jnp.inf)
    kth = jax.lax.top_k(scores.transpose(0, 2, 1), k)[0][..., -1]
    gate = scores >= jnp.where(jnp.isfinite(kth), kth, jnp.inf)[:, None, :]
    return jnp.any(gate & (per_gt > 0), axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_gate_equals_jax_exactly(seed):
    """Centerness targets on a grid of 8 values (ties at the k-th value),
    each gt given 0 to 12 positives: the gt with fewer than 5 positives let
    nothing through, in both packages."""
    rs = np.random.RandomState(70 + seed)
    B, L, G = 2, 200, 7
    gt_inds = rs.randint(0, G, (B, L))
    pos = rs.rand(B, L) < 0.15
    for b in range(B):       # gt 0: 3 positives, gt 1: exactly 5
        for g, n in ((0, 3), (1, 5)):
            rows = np.flatnonzero(gt_inds[b] == g)
            pos[b, rows] = False
            pos[b, rows[:n]] = True
    ctr = np.where(pos, rs.randint(1, 9, (B, L)) / 8.0, 0.0).astype(np.float32)
    want = np.asarray(jax_gate(jnp.asarray(ctr), jnp.asarray(pos), jnp.asarray(gt_inds), G, 5))
    got = tfcos.topk_per_gt_gate(torch.from_numpy(ctr), torch.from_numpy(pos),
                                 torch.from_numpy(gt_inds), G, 5).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        assert not got[b][gt_inds[b] == 0].any()              # 3 positives: none pass
        assert got[b][(gt_inds[b] == 1) & pos[b]].all()        # 5 positives: all pass
        assert got[b].sum() >= 5 and got[b].sum() < pos[b].sum()


@pytest.fixture(scope="module")
def fcos_variables():
    return draw_variables(jax_build_model(tiny_cfg(jax_get_cfg, TOPK_CONFIG)), 71)


def test_fcos_topk_loss_matches_jax(fcos_variables):
    """The gate changes the regression loss (gt of 2-60 px: some with
    fewer than 5 positives, some with more) and the port follows JAX."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, TOPK_CONFIG))
    assert det.topk_per_gt == 5
    batch = train_batch(72)
    total, metrics = jax.jit(det.loss)(jax.tree_util.tree_map(jnp.asarray, fcos_variables),
                                       jnp_batch(batch))
    model = port_model(TOPK_CONFIG, fcos_variables)
    assert type(model).__name__ == "FCOSTopK" and model.topk_per_gt == 5
    got, got_metrics = model.loss(batch)
    assert sorted(got_metrics) == sorted(k for k in metrics if not k.startswith("_"))
    assert float(got.detach()) == pytest.approx(float(total), rel=MODEL_LOSS_RTOL)
    for k in got_metrics:
        assert float(got_metrics[k].detach()) == pytest.approx(float(metrics[k]),
                                                               rel=MODEL_LOSS_RTOL), k
    plain = port_model(TOPK_CONFIG, fcos_variables,
                       **{"MODEL.META_ARCHITECTURE": "FCOS"})
    _, plain_metrics = plain.loss(batch)
    assert float(plain_metrics["reg_loss"]) != float(got_metrics["reg_loss"])
    assert float(plain_metrics["cls_loss"]) == float(got_metrics["cls_loss"])


# ---------------------------------------------------------- FCOSAnchor
@pytest.fixture(scope="module")
def fa_variables():
    """FCOSAnchor with 3 anchors a location."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, ANCHOR_CONFIG, **THREE_ANCHORS))
    return draw_variables(det, 73, **FA_CONVS)


@pytest.fixture(scope="module")
def fa_jax(fa_variables):
    """The JAX head outputs (those the loss consumed), loss, metrics and
    gradients on one batch, from one jitted call."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, ANCHOR_CONFIG, **THREE_ANCHORS))
    det.module = capture = Capture(det.module)
    jvars = jax.tree_util.tree_map(jnp.asarray, fa_variables)
    batch = train_batch(74)

    def run(v, b):
        def loss_fn(params):
            total, metrics = det.loss({**v, "params": params}, b)
            return total, (metrics, capture.outputs)

        (total, (metrics, outs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        return outs, ((total, metrics), grads)

    outs, ((total, metrics), grads) = jax.jit(run)(jvars, jnp_batch(batch))
    return {"det": det, "batch": batch, "outputs": jax.tree_util.tree_map(np.asarray, outs),
            "total": float(total), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})}


@pytest.mark.parametrize("hw", [(64, 96), (896, 1408)])
def test_anchor_offsets_equal_jax_exactly(hw):
    det = jax_build_model(tiny_cfg(jax_get_cfg, ANCHOR_CONFIG, **THREE_ANCHORS))
    model = torch_build_model(tiny_cfg(torch_get_cfg, ANCHOR_CONFIG, **THREE_ANCHORS),
                              device="cpu")
    assert model.num_anchors == det.num_anchors == 3
    for got, want in zip(model._geometry(hw), det._geometry(hw)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_anchor_iou_terms_match_jax():
    rs = np.random.RandomState(75)
    pred = rs.uniform(-5, 60, (300, 4)).astype(np.float32)
    target = rs.uniform(0.5, 60, (300, 4)).astype(np.float32)
    for got, want in zip(tfa.anchor_iou_terms(torch.from_numpy(pred), torch.from_numpy(target)),
                         jfa.anchor_iou_terms(jnp.asarray(pred), jnp.asarray(target))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_fcos_anchor_head_outputs_match_jax(fa_variables, fa_jax):
    model = port_model(ANCHOR_CONFIG, fa_variables, **THREE_ANCHORS)
    with torch.no_grad():
        got = model(torch.from_numpy(fa_jax["batch"]["image"]))
    cells = [8 * 12, 4 * 6, 2 * 3, 1 * 2, 1 * 1]
    for part, (g_l, w_l) in enumerate(zip(got, fa_jax["outputs"])):
        for lvl, (g, w) in enumerate(zip(g_l, w_l)):
            n = cells[lvl] * (1 if part == 2 else 3)
            shape = {0: (2, n, 80), 1: (2, n, 4), 2: (2, n), 3: (2, n)}[part]
            assert tuple(g.shape) == w.shape == shape
            np.testing.assert_allclose(g.numpy(), w, **HEAD_TOL, err_msg=f"part {part} {lvl}")


def test_fcos_anchor_loss_and_gradients_match_jax(fa_variables, fa_jax):
    cfg = tiny_cfg(torch_get_cfg, ANCHOR_CONFIG, **THREE_ANCHORS)
    model = port_model(ANCHOR_CONFIG, fa_variables, **THREE_ANCHORS)
    tsolver.build_optimizer(cfg, model)           # applies FREEZE_AT
    total, metrics = model.loss(fa_jax["batch"])
    want = fa_jax["metrics"]
    assert sorted(metrics) == sorted(want) == ["centerness_loss", "cls_loss", "num_pos",
                                               "reg_loss", "shape_loss"]
    assert float(total.detach()) == pytest.approx(fa_jax["total"], rel=MODEL_LOSS_RTOL)
    for k, v in want.items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=MODEL_LOSS_RTOL), k
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            continue
        assert torch.isfinite(p.grad).all(), name
        assert ratio(p.grad.numpy(), fa_jax["grads"][name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"head.shape_cls.weight", "head.centerness.bias", "head.bbox_pred.weight",
            "head.scale2.scale", "head.cls_gn0.weight",
            "backbone.bottom_up.res4_0.conv1.weight"} <= checked
    assert float(model.head.shape_cls.weight.grad.abs().max()) > 0


def test_fcos_anchor_predict_matches_jax(fa_variables, fa_jax):
    """Scores of cls x the centerness-shape gate on both sides of
    INFERENCE_TH squared: a few dozen detections an image, slot for slot."""
    variables = draw_variables(fa_jax["det"], 73, **FA_CONVS, cls_logits=(0.02, -8.0))
    rs = np.random.RandomState(77)
    batch = {"image": rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
             "scale": np.array([1.0, 0.8], np.float32),
             "orig_size": np.array([[64, 96], [51, 76]], np.float32)}
    want = jax.jit(fa_jax["det"].predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                          jnp_batch(batch))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = port_model(ANCHOR_CONFIG, variables, **THREE_ANCHORS).predict(batch)
    valid = want["valid"]
    assert (valid.sum(1) >= 5).all() and (valid.sum(1) < 100).all(), valid.sum(1)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("config,arch,anchors", [(TOPK_CONFIG, "FCOSTopK", None),
                                                 (ANCHOR_CONFIG, "FCOSAnchor", 1)])
def test_yamls_build_at_full_width_on_the_cpu(config, arch, anchors):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(config))
    cfg.MODEL.RESNETS.DEPTH = 18
    model = torch_build_model(cfg, device="cpu")
    assert type(model).__name__ == arch and model.dtype == torch.bfloat16
    if anchors is not None:
        assert model.num_anchors == anchors and model.head.cls_logits.out_channels == 80
        assert model.head.cls_tower3.weight.shape == (256, 256, 3, 3)
        assert float(model.head.cls_logits.bias[0].detach()) == pytest.approx(-np.log(99.0))
