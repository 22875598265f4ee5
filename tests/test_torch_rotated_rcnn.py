"""The port's rotated Faster R-CNN (``ProposalVisibleRCNN`` with RRPN and
RROIHeads, ``configs/rotated/faster_rcnn_rotated_R_50_FPN_1x.yaml``) held
against the JAX package on the CPU, in float32 at a tiny size (R-18,
64 x 64 images, 8 padded gt, the YAML's 9 anchors a cell at P2-P6):

- ROIAlignRotated: one level against the JAX op (and its direct-loop
  oracle's RoIs), both multilevel poolers forward (1e-5) and their feature
  gradient (1e-4);
- ``sample_rotated_proposals`` exactly, fed the JAX package's own
  priorities (``jax.random`` bits cannot be reproduced in torch);
- the RRPN's and the RROIHeads' losses (1e-4) with the JAX priorities, the
  whole model's losses (1e-4) and gradients (1e-3) with every candidate
  sampled;
- the RRPN's proposals and the box head's detections in two parts, as
  ``tests/test_torch_rotated_retinanet.py`` explains: the NMS input against
  the JAX package's (box-head scores 1e-5, the RPN's logits 1e-5 of their
  largest, boxes 1e-3 px plus 1e-5 of their size, masks exactly), and the
  port's NMS on the JAX input equal to the JAX NMS, keep list for keep
  list;
- ``train_net_torch.main`` over 4 steps with sampling on, on an ``rcoco``
  dataset of rotated polygons, evaluated by the ``rcoco`` evaluator, resumed
  bit-equal to an uninterrupted run;
- the four rotated YAMLs build on the CPU, and either rotated name selects
  the rotated detector.

The JAX side is compiled at XLA's backend optimisation level 0
(``tests/test_torch_rotated_ops.py:jax_exact``). Every input is made from a
numpy seed inside its test.
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

from test_torch_rcnn import per_image_priorities, jax_priorities  # noqa: E402
from test_torch_rotated_ops import ANGLES, jax_exact  # noqa: E402
from test_torch_rotated_retinanet import (rcoco_dataset,  # noqa: E402
                                          resumed_run_is_bit_equal)

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.proposal_generator.rrpn import RotatedRPN  # noqa: E402
from slenderobjdet_torch.models.roi_heads import rotated as troi  # noqa: E402
from slenderobjdet_torch.ops import roi_align_rotated as tra  # noqa: E402
from slenderobjdet_torch.ops.rotated import offset_boxes, rotated_nms  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.proposal_generator import rrpn as jrrpn  # noqa: E402
from slenderobjdet_tpu.models.roi_heads import rotated as jroi  # noqa: E402
from slenderobjdet_tpu.ops import roi_align_rotated as jra  # noqa: E402
from slenderobjdet_tpu.ops import rotated as jrot  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/rotated/faster_rcnn_rotated_R_50_FPN_1x.yaml"
ROTATED_YAMLS = ["rotated/Base-RRCNN-FPN.yaml", "rotated/faster_rcnn_rotated_R_50_FPN_1x.yaml",
                 "rotated/rotated_retinanet_R_50_FPN_1x.yaml", "submit/test_dev.yaml"]
POOL_TOL = 1e-5
POOL_GRAD_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
SELECT_ALL = {"MODEL.RPN.BATCH_SIZE_PER_IMAGE": 8192,
              "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 512}
SMALL_TOPK = {"MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.PRE_NMS_TOPK_TEST": 100,
              "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100, "MODEL.RPN.POST_NMS_TOPK_TEST": 50}


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


def tiny_cfg(get_cfg, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in {**SMALL_TOPK, **overrides}.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def int_rboxes(rs, shape, lo_c=8, hi_c=56):
    return np.stack([rs.randint(lo_c, hi_c, shape), rs.randint(lo_c, hi_c, shape),
                     rs.randint(6, 40, shape), rs.randint(4, 24, shape),
                     rs.choice(ANGLES, shape)], -1).astype(np.float32)


def batch_of(seed, batch=2):
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, 8), bool)
    valid[:, 6:] = False
    return {"image": rs.randint(0, 256, (batch, 64, 64, 3)).astype(np.uint8),
            "gt_rboxes": int_rboxes(rs, (batch, 8)),
            "gt_classes": rs.randint(0, 80, (batch, 8)).astype(np.int32),
            "gt_valid": valid,
            "image_size": np.array([[64, 64], [60, 50]], np.int32)[:batch]}


# ------------------------------------------------------------------ poolers
def test_roi_align_rotated_matches_jax():
    """The JAX tests' oracle RoIs (angles 0, 30, -60, 120) and random ones,
    including RoIs over the border."""
    rs = np.random.RandomState(70)
    feat = rs.randn(14, 11, 3).astype(np.float32)
    rois = np.concatenate([
        np.array([[5.0, 6.0, 6.0, 4.0, 0.0], [4.5, 7.5, 8.0, 3.0, 30.0],
                  [6.0, 5.0, 5.0, 9.0, -60.0], [7.0, 7.0, 10.0, 10.0, 120.0]], np.float32),
        (rs.rand(40, 5) * [16, 18, 12, 12, 360] - [2, 2, -1, -1, 180]).astype(np.float32)])
    want = jax_exact(lambda f, r: jra.roi_align_rotated(f, r, 1.0, 4, 2, roi_chunk=16),
                     feat, rois)
    got = tra.roi_align_rotated(torch.from_numpy(feat), torch.from_numpy(rois), 1.0, 4, 2,
                                roi_chunk=16)
    assert got.shape == (44, 4, 4, 3)
    assert ratio(got.numpy(), want) <= POOL_TOL


@pytest.fixture(scope="module")
def pool_case():
    rs = np.random.RandomState(71)
    strides, shapes = [4, 8, 16, 32], [(24, 32), (12, 16), (6, 8), (3, 4)]
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in shapes]
    rois = np.stack([rs.rand(2, 60) * 128, rs.rand(2, 60) * 96, rs.rand(2, 60) * 300 + 2,
                     rs.rand(2, 60) * 200 + 2, rs.rand(2, 60) * 360 - 180], -1)
    return strides, feats, rois.astype(np.float32)


@pytest.mark.parametrize("name", ["multilevel_roi_align_rotated",
                                  "multilevel_roi_align_rotated_fused"])
def test_rotated_poolers_match_jax(pool_case, name):
    strides, feats, rois = pool_case
    jfn, tfn = getattr(jra, name), getattr(tra, name)

    def jax_pool(*fs):
        return jax.vmap(lambda *a: jfn(list(a[:-1]), strides, a[-1], 7, 2))(
            *fs, jnp.asarray(rois))

    cot = np.random.RandomState(72).randn(2, 60, 7, 7, 16).astype(np.float32)
    want, grads = jax_exact(lambda *fs: (jax_pool(*fs), jax.grad(
        lambda *g: jnp.sum(jax_pool(*g) * cot), argnums=(0, 1, 2, 3))(*fs)), *feats)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    got = tfn(tf, strides, torch.from_numpy(rois), 7, 2, roi_chunk=32)
    assert got.shape == want.shape == (2, 60, 7, 7, 16)
    assert ratio(got.detach().numpy(), want) <= POOL_TOL
    (got * torch.from_numpy(cot)).sum().backward()
    used = 0
    for t, g in zip(tf, grads):
        if np.abs(g).max() > 0:
            used += 1
            assert ratio(t.grad.permute(0, 2, 3, 1).numpy(), g) <= POOL_GRAD_TOL
        else:
            assert float(t.grad.abs().max()) == 0.0
    assert used >= 3


# ----------------------------------------------------------------- sampling
@pytest.mark.parametrize("num_samples", [16, 64, 512])
def test_sample_rotated_proposals_equals_jax_exactly(num_samples):
    rs = np.random.RandomState(73 + num_samples)
    gt = int_rboxes(rs, (8,))
    gt[1] = gt[0]
    gt_valid = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    near = gt[rs.randint(0, 6, 60)] + np.concatenate(
        [rs.randint(-4, 5, (60, 4)), np.zeros((60, 1))], 1).astype(np.float32)
    props = np.concatenate([near, int_rboxes(rs, (40,))]).astype(np.float32)
    prop_valid = rs.rand(100) < 0.9
    classes = rs.randint(0, 80, 8).astype(np.int32)
    rng = jax.random.PRNGKey(74 + num_samples)
    args = (props, prop_valid, gt, classes, gt_valid)
    want = jax_exact(lambda *a: jroi.sample_rotated_proposals(
        rng, *a, num_samples, 0.25, [0.5], [0, 1], 80), *args)
    got = troi.sample_rotated_proposals(*map(torch.from_numpy, args), num_samples, 0.25,
                                        [0.5], [0, 1], 80,
                                        priorities=jax_priorities(rng, 108))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    rois, cls, _, row_valid = got
    assert rois.shape == (min(num_samples, 108), 5)
    assert 0 < int((cls < 80).sum()) < int(row_valid.sum())


# ------------------------------------------------------------------ model
def _randomize(variables, seed):
    """FrozenBN away from identity, the RPN's delta filters and the box
    head's regression and classifier scaled down (``test_torch_rcnn.py``)."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    for node in jax.tree_util.tree_leaves(
            out["buffers"], is_leaf=lambda v: isinstance(v, dict) and "scale" in v):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    out["params"]["rpn_head"]["anchor_deltas"]["kernel"] *= 0.01
    out["params"]["roi_box"]["outputs"]["bbox_pred"]["kernel"] *= 0.1
    out["params"]["roi_box"]["outputs"]["cls_score"]["kernel"] *= 0.2
    return out


@pytest.fixture(scope="module")
def rrcnn_pair():
    det = jax_build_model(tiny_cfg(jax_get_cfg, **SELECT_ALL))
    assert det.rotated
    return det, _randomize(det.init_variables(jax.random.PRNGKey(0)), seed=75)


def torch_model(variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def test_bridge_carries_the_rotated_rcnn_tree(rrcnn_pair):
    _, variables = rrcnn_pair
    sd = flax_to_state_dict(variables)
    model = torch_model(variables)
    assert model.rotated and isinstance(model.rpn, RotatedRPN)
    assert isinstance(model.roi_heads, troi.RotatedROIHeads)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert sd["rpn_head.anchor_deltas.weight"].shape == (9 * 5, 256, 1, 1)
    assert sd["roi_box.outputs.bbox_pred.weight"].shape == (80 * 5, 1024)


def test_rrpn_losses_match_jax_with_its_draws(rrcnn_pair):
    det, variables = rrcnn_pair
    model = torch_model(variables, **{"MODEL.RPN.BATCH_SIZE_PER_IMAGE": 256})
    jdet = jax_build_model(tiny_cfg(jax_get_cfg))
    batch = batch_of(76)
    with torch.no_grad():
        logits_l, deltas_l, _ = model(torch.from_numpy(batch["image"]))
    logits, deltas = torch.cat(logits_l, 1), torch.cat(deltas_l, 1)
    anchors, _ = model.rpn_anchors((64, 64))
    assert anchors.shape == (3069, 5) and deltas.shape == (2, 3069, 5)
    rng = jax.random.PRNGKey(77)
    gts = (batch["gt_rboxes"], batch["gt_classes"], batch["gt_valid"])
    want = jax_exact(lambda *a: jdet.rpn.losses(rng, *a), anchors.numpy(), logits.numpy(),
                     deltas.numpy(), *gts)
    got = model.rpn.losses(anchors, logits, deltas, *map(torch.from_numpy, gts),
                           priorities=per_image_priorities(rng, 2, 3069))
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
        assert float(got[k]) > 0


def test_rroi_losses_match_jax_with_its_draws(rrcnn_pair):
    _, variables = rrcnn_pair
    over = {"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16}
    model = torch_model(variables, **over)
    jdet = jax_build_model(tiny_cfg(jax_get_cfg, **over))
    rs = np.random.RandomState(78)
    feats = [rs.randn(2, 64 // s, 64 // s, 256).astype(np.float32) for s in (4, 8, 16, 32)]
    batch = batch_of(79)
    gt = batch["gt_rboxes"]
    near = gt[:, rs.randint(0, 6, 60)] + np.concatenate(
        [rs.randint(-4, 5, (2, 60, 4)), np.zeros((2, 60, 1))], -1)
    props = np.concatenate([near, int_rboxes(rs, (2, 40))], 1).astype(np.float32)
    prop_valid = rs.rand(2, 100) < 0.9
    rng = jax.random.PRNGKey(80)
    gts = (batch["gt_rboxes"], batch["gt_classes"], batch["gt_valid"])
    want = jax_exact(lambda v, fs, *a: jdet.roi_heads.losses(rng, v, list(fs), *a),
                     {"params": variables["params"]["roi_box"]}, feats, props, prop_valid, *gts)
    got = model.roi_heads.losses(
        model.roi_box, [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
        torch.from_numpy(props), torch.from_numpy(prop_valid), *map(torch.from_numpy, gts),
        priorities=per_image_priorities(rng, 2, 108))
    for k in ("loss_cls", "loss_box_reg"):
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
    assert int(got["num_fg"]) == int(want["num_fg"]) > 2


def test_rotated_rcnn_loss_and_gradients_match_jax(rrcnn_pair):
    det, variables = rrcnn_pair
    cfg = tiny_cfg(torch_get_cfg, **SELECT_ALL)
    model = torch_model(variables, **SELECT_ALL)
    tsolver.build_optimizer(cfg, model)
    batch = batch_of(81)

    def loss_fn(params, b):
        return det.loss({**jax.tree_util.tree_map(jnp.asarray, variables), "params": params}, b)

    (want, want_metrics), grads = jax_exact(jax.value_and_grad(loss_fn, has_aux=True),
                                            variables["params"], batch)
    grads = flax_to_state_dict({"params": grads})
    total, metrics = model.loss(batch)
    assert sorted(metrics) == sorted(want_metrics) == [
        "loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc", "num_fg"]
    assert float(total.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    for k, v in want_metrics.items():
        assert float(metrics[k].detach()) == pytest.approx(float(v), rel=LOSS_RTOL), k
    assert float(metrics["num_fg"]) > 2
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        assert ratio(p.grad.numpy(), grads[name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"backbone.bottom_up.res4_0.conv1.weight", "rpn_head.conv.weight",
            "rpn_head.anchor_deltas.bias", "roi_box.head.fc1.weight",
            "roi_box.outputs.bbox_pred.bias"} <= checked


def jax_nms(boxes, scores, groups, valid, thr, max_out):
    shifted = offset_boxes(torch.from_numpy(boxes), torch.from_numpy(groups)).numpy()
    out = jax_exact(jax.vmap(lambda b, s, v: jnp.stack(jrot.rotated_nms(
        b, s, thr, max_out, valid=v))), shifted, scores, valid)
    return out[:, 0], out[:, 1].astype(bool)


def port_nms(boxes, scores, groups, valid, thr, max_out):
    return rotated_nms(offset_boxes(torch.from_numpy(boxes), torch.from_numpy(groups)),
                       torch.from_numpy(scores), thr, max_out, valid=torch.from_numpy(valid))


def test_rotated_rcnn_predict_matches_jax(rrcnn_pair):
    """The RRPN's NMS input (each level's top-k, decoded, clipped, the
    min-size mask) against the JAX package's, and the port's level-aware NMS
    on the JAX input equal to the JAX one; then the box head on the JAX
    proposals: the (proposal, class) candidates and the class-aware NMS the
    same way; ``predict`` returns XYWHA detections and proposals rescaled
    by the scale, the angle as it is."""
    _, variables = rrcnn_pair
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    model = torch_model(variables)
    rs = np.random.RandomState(82)
    images = rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [60, 52]], np.int32)
    main_vars, roi_vars = det._split_variables(jax.tree_util.tree_map(jnp.asarray, variables))
    anchors_np, counts = det.rpn.anchor_spec.anchors((64, 64))
    offsets = np.concatenate([[0], np.cumsum(counts)])

    def jax_rrpn_candidates(v, x, hw):
        logits_l, deltas_l, feats = det.module.apply(v, x)
        logits, deltas = jnp.concatenate(logits_l, 1), jnp.concatenate(deltas_l, 1)
        out = []
        for lvl in range(len(counts)):
            sl = slice(offsets[lvl], offsets[lvl + 1])
            k = min(det.rpn.pre_nms_topk[False], counts[lvl])
            top, idx = jax.lax.top_k(logits[:, sl], k)
            sel = jnp.take_along_axis(deltas[:, sl], idx[..., None], axis=1)
            out.append((jrot.apply_rotated_deltas(sel, jnp.asarray(anchors_np[sl])[idx],
                                                  weights=det.rpn.bbox_reg_weights),
                        top, jnp.full(top.shape, lvl, jnp.int32)))
        boxes, scores, levels = (jnp.concatenate(t, 1) for t in zip(*out))
        boxes = jax.vmap(lambda b, s: jrrpn.clip_rotated_boxes(b, s[0], s[1]))(
            boxes, hw.astype(jnp.float32))
        ok = (boxes[..., 2] > det.rpn.min_size) & (boxes[..., 3] > det.rpn.min_size)
        return boxes, scores, levels, ok, feats

    jb, js, jl, jok, jfeats = jax_exact(jax_rrpn_candidates, main_vars, images, sizes)
    with torch.no_grad():
        logits_l, deltas_l, feats = model(torch.from_numpy(images))
        anchors, cnt = model.rpn_anchors((64, 64))
        gb, gs, gok, _, gl = model.rpn.candidates(anchors, cnt, torch.cat(logits_l, 1),
                                                   torch.cat(deltas_l, 1), sizes, False)
    np.testing.assert_array_equal(gok.numpy(), jok)
    np.testing.assert_array_equal(gl.numpy(), jl)
    assert ratio(gs.numpy(), js) <= 1e-5              # the RPN's logits, of size ~25
    np.testing.assert_allclose(gb.numpy()[jok], jb[jok], rtol=1e-5, atol=1e-3)
    post = det.rpn.post_nms_topk[False]
    want = jax_nms(jb, js, jl, jok, det.rpn.nms_thresh, post)
    got = port_nms(jb, js, jl, jok, det.rpn.nms_thresh, post)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert want[1].sum(1).min() > 20

    # the box head on the JAX proposals
    props = np.take_along_axis(jb, want[0][..., None].astype(np.int64), 1)
    prop_valid = want[1]
    roi = det.roi_heads

    def jax_box_candidates(v, fs, p, pv):
        pooled = jax.vmap(lambda *a: roi.pool(list(a[:-1]), a[-1], fused=True))(*fs, p)
        scores, deltas = roi.module.apply(v, pooled)
        probs = jax.nn.softmax(scores, axis=-1)[..., :-1]
        B, R, C = probs.shape
        boxes = jrot.apply_rotated_deltas(deltas.reshape(B, R, C, 5), p[:, :, None, :],
                                          weights=roi.bbox_reg_weights)
        flat = jnp.where(pv[..., None], probs, 0.0).reshape(B, R * C)
        top, idx = jax.lax.top_k(flat, min(1000, R * C))
        sel = jnp.take_along_axis(boxes.reshape(B, R * C, 5), idx[..., None], axis=1)
        return sel, top, (idx % C).astype(jnp.int32), top > roi.score_thresh

    tfeats = [torch.from_numpy(np.asarray(f)).permute(0, 3, 1, 2) for f in jfeats]
    wb, ws, wc, wv = jax_exact(jax_box_candidates, roi_vars, jfeats, props, prop_valid)
    with torch.no_grad():
        cb, cs, cc, cv, _ = model.roi_heads.candidates(
            model.roi_box, tfeats, torch.from_numpy(props), torch.from_numpy(prop_valid))
    np.testing.assert_array_equal(cv.numpy(), wv)
    assert 0 < wv.sum() < wv.size
    np.testing.assert_array_equal(cc.numpy()[wv], wc[wv])
    np.testing.assert_allclose(cs.numpy()[wv], ws[wv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(cb.numpy()[wv], wb[wv], rtol=1e-5, atol=1e-3)
    want = jax_nms(wb, ws, wc, wv, roi.nms_thresh, roi.max_dets)
    got = port_nms(wb, ws, wc, wv, roi.nms_thresh, roi.max_dets)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])

    batch = {"image": images, "scale": np.array([1.0, 0.8], np.float32),
             "orig_size": np.array([[64, 64], [51, 51]], np.float32), "image_size": sizes}
    out = model.predict(batch)
    assert sorted(out) == ["boxes", "classes", "proposal_scores", "proposal_valid",
                           "proposals", "scores", "valid"]
    assert out["boxes"].shape == (2, 100, 5) and out["proposals"].shape == (2, post, 5)
    p = out["proposals"].numpy()[1][out["proposal_valid"].numpy()[1]]
    assert np.isfinite(p).all() and (np.abs(p[:, 4]) <= 180).all()


# ----------------------------------------------------------------- trainer
NAME = "torch_rcoco_rcnn_synth"
TINY = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.ROI_HEADS.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10, **SMALL_TOPK,
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.CHECKPOINT_PERIOD": 100,
    "SOLVER.BASE_LR": 1e-4, "SOLVER.WARMUP_ITERS": 3,
}


def test_rotated_rcnn_main_resumes_bit_equal_and_evaluates(tmp_path, monkeypatch):
    rcoco_dataset(tmp_path, NAME)
    results = resumed_run_is_bit_equal(tmp_path, CONFIG, TINY, monkeypatch)
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"])


# ----------------------------------------------------------------- building
@pytest.mark.parametrize("yaml_name", ROTATED_YAMLS)
def test_rotated_yamls_build_on_the_cpu(yaml_name):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / yaml_name))
    model = torch_build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    assert all(p.device.type == "cpu" for p in model.parameters())
    if "retinanet" in yaml_name:
        assert type(model).__name__ == "RotatedRetinaNet"
        assert model.anchor_spec.num_cell_anchors == [27] * 5
        assert model.head.bbox_pred.out_channels == 27 * 5
    else:
        assert type(model).__name__ == "ProposalVisibleRCNN" and model.rotated
        assert model.rpn.num_cell_anchors == 9 and model.rpn_head.box_dim == 5
        assert model.roi_box.outputs.bbox_pred.out_features == 80 * 5
        assert model.roi_heads.bbox_reg_weights == (10.0, 5.0, 5.0, 5.0, 1.0)


@pytest.mark.parametrize("overrides", [{"MODEL.PROPOSAL_GENERATOR.NAME": "RPN"},
                                       {"MODEL.ROI_HEADS.NAME": "StandardROIHeads"}])
def test_either_rotated_name_selects_the_rotated_detector(overrides):
    """As in the JAX package, RRPN or RROIHeads alone makes the detector
    rotated throughout."""
    model = torch_build_model(tiny_cfg(torch_get_cfg, **overrides), device="cpu")
    jdet = jax_build_model(tiny_cfg(jax_get_cfg, **overrides))
    assert model.rotated and jdet.rotated
    assert isinstance(model.rpn, RotatedRPN)
    assert isinstance(model.roi_heads, troi.RotatedROIHeads)
