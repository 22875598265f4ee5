"""The PyTorch port's RetinaNet chassis held against the JAX package on the
CPU, in float32 at a tiny size (R-18, 64 x 64 images, 8 padded gt): anchors
(bit for bit), the box coding, the three matchers and the nearest-point
assignment (exactly, on integer-pixel boxes that tie), the three assignment
modes, the FPN on res5 with the head, ``RetinaNet.loss`` with its gradients,
``RetinaNet.predict`` with and without anchors, the no-centerness and
with-anchor FCOS variants, and the registry of the eleven ported names.

Both sides get the same weights: the JAX package's initialisation with
FrozenBN buffers drawn from a numpy seed, carried to the port by
``checkpoint/bridge.py``. Every input is made from a numpy seed inside its
test. The JAX side runs with ``TPU.APPROX_TOPK`` off.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.models import META_ARCHS
from slenderobjdet_torch.models import anchors as tanchors
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.models import matchers as tmatch
from slenderobjdet_torch.models.meta_arch import reppoints as trep
from slenderobjdet_torch.models.meta_arch import retinanet as tretina
from slenderobjdet_torch.solver import build as tsolver
from slenderobjdet_torch.structures import boxes as tbox
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.models import anchors as janchors
from slenderobjdet_tpu.models import build_model as jax_build_model
from slenderobjdet_tpu.models import matchers as jmatch
from slenderobjdet_tpu.models.meta_arch import reppoints as jrep
from slenderobjdet_tpu.models.meta_arch import retinanet as jretina
from slenderobjdet_tpu.structures import boxes as jbox
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
RETINA = ROOT / "configs/retina"
FCOS_CONFIG = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
BOX_TOL = dict(rtol=1e-6, atol=1e-6)     # the box coding: same fp ops, float32
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)    # per-level logits and deltas
MODEL_LOSS_RTOL = 1e-4   # tests/test_torch_train.py: whole-model losses
GRAD_TOL = 1e-3          # tests/test_torch_train.py: per tensor, max |diff| / max |JAX gradient|
ELEVEN = ["FCOS", "FCOSV2", "GroupNet", "FCOSWithAnchor", "FCOSRetinaNet", "FCOSNCRetinaNet",
          "RetinaNet", "RetinaNetWithAnchor", "CenternessRetinaNet", "NearestRetinaNet",
          "PointRetinaNet"]


def tiny_cfg(get_cfg, arch="RetinaNet", config=None, **overrides):
    """R-18, fp32, exact top-k, from the architecture's own YAML family."""
    cfg = get_cfg()
    if config is None:
        config = (RETINA / "retinanet_R_50_FPN_1x.yaml" if "Retina" in arch
                  else FCOS_CONFIG)
    cfg.merge_from_file(str(config))
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


def train_batch(seed=0, batch=2, g=8, hw=(64, 64)):
    """uint8 images and integer-pixel gt boxes, the last rows padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": int_boxes(rs, (batch, g), 40, 6, 30),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


# ----------------------------------------------------------------- anchors
def test_base_yaml_anchor_sizes_equal_the_jax_configs():
    want, got = jax_get_cfg(), torch_get_cfg()
    for cfg in (want, got):
        cfg.merge_from_file(str(RETINA / "Base-RetinaNet.yaml"))
    sizes = got.MODEL.ANCHOR_GENERATOR.SIZES
    assert sizes == want.MODEL.ANCHOR_GENERATOR.SIZES
    assert len(sizes) == 5 and sizes[1][2] == 64 * 2 ** (2.0 / 3)
    assert got.dump() == want.dump()


@pytest.mark.parametrize("image_hw", [(64, 64), (896, 1408), (1408, 896)])
def test_anchors_equal_the_jax_packages_bit_for_bit(image_hw):
    strides = [8, 16, 32, 64, 128]
    want = janchors.AnchorGeneratorSpec(tiny_cfg(jax_get_cfg), strides)
    got = tanchors.AnchorGeneratorSpec(tiny_cfg(torch_get_cfg), strides)
    assert got.num_cell_anchors == want.num_cell_anchors == [9] * 5
    for g, w in zip(got.cell_anchors, want.cell_anchors):
        np.testing.assert_array_equal(g, w)
    (ga, gc), (wa, wc) = got.anchors(image_hw), want.anchors(image_hw)
    assert gc == wc and ga.dtype == wa.dtype == np.float32
    np.testing.assert_array_equal(ga, wa)
    if image_hw == (896, 1408):
        assert sum(gc) == 236313


def test_broadcast_sizes_and_offset_match_jax():
    over = {"MODEL.ANCHOR_GENERATOR.SIZES": [[32, 64]], "MODEL.ANCHOR_GENERATOR.OFFSET": 0.5,
            "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[1.0], [0.5, 2.0]]}
    want = janchors.AnchorGeneratorSpec(tiny_cfg(jax_get_cfg, **over), [8, 16])
    got = tanchors.AnchorGeneratorSpec(tiny_cfg(torch_get_cfg, **over), [8, 16])
    assert got.num_cell_anchors == want.num_cell_anchors == [2, 4]
    np.testing.assert_array_equal(got.anchors((40, 56))[0], want.anchors((40, 56))[0])


# -------------------------------------------------------------- box coding
def _float_boxes(rs, n):
    xy = rs.uniform(0, 80, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(0.5, 60, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_delta_coding_matches_jax(weights):
    rs = np.random.RandomState(20)
    src, tgt = _float_boxes(rs, 200), _float_boxes(rs, 200)
    src[:3, 2:] = src[:3, :2]            # empty sources: the 1e-7 floor
    want = np.asarray(jbox.get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights))
    got = tbox.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt), weights)
    np.testing.assert_allclose(got.numpy()[3:], want[3:], **BOX_TOL)
    np.testing.assert_allclose(got.numpy()[:3], want[:3], rtol=1e-6)
    np.testing.assert_allclose(tbox.get_deltas(src, tgt, weights)[3:], want[3:], **BOX_TOL)

    # decoding, with dw and dh beyond SCALE_CLAMP and K = 3 boxes a row
    deltas = (rs.randn(200, 12) * np.tile([0.5, 0.5, 3.0, 3.0], 3)).astype(np.float32)
    deltas[:, 2] = 9.0 * weights[2]
    assert tbox.SCALE_CLAMP == jbox.SCALE_CLAMP < 9.0
    want = np.asarray(jbox.apply_deltas(jnp.asarray(deltas), jnp.asarray(src), weights))
    got = tbox.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src), weights)
    assert got.shape == (200, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(tbox.apply_deltas(deltas, src, weights), want, rtol=1e-6, atol=1e-3)
    # the clamp: a width of exactly e^SCALE_CLAMP times the source's
    w = (got[3:, 2] - got[3:, 0]).numpy() / (src[3:, 2] - src[3:, 0])
    np.testing.assert_allclose(w, 1000.0 / 16.0, rtol=1e-4)
    # a round trip decodes the target
    back = tbox.apply_deltas(tbox.get_deltas(torch.from_numpy(src[3:]), torch.from_numpy(tgt[3:]),
                                             weights), torch.from_numpy(src[3:]), weights)
    np.testing.assert_allclose(back.numpy(), tgt[3:], rtol=0, atol=1e-3)


def test_box_helpers_match_jax():
    rs = np.random.RandomState(21)
    a, b = _float_boxes(rs, 40), _float_boxes(rs, 60)
    b[:2, 2:] = b[:2, :2]                # zero-area boxes2: ioa is 0 there
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = np.asarray(jbox.pairwise_ioa(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tbox.pairwise_ioa(ta, tb).numpy(), want, **BOX_TOL)
    np.testing.assert_allclose(tbox.pairwise_ioa(a, b), want, **BOX_TOL)
    assert (want[:, :2] == 0).all() and want.max() > 0.5

    c = (a + rs.uniform(-5, 5, a.shape)).astype(np.float32)
    want = np.asarray(jbox.elementwise_iou(jnp.asarray(a), jnp.asarray(c)))
    np.testing.assert_allclose(tbox.elementwise_iou(ta, torch.from_numpy(c)).numpy(), want,
                               **BOX_TOL)
    np.testing.assert_allclose(tbox.elementwise_iou(a, c), want, **BOX_TOL)

    locs = rs.uniform(0, 100, (30, 2)).astype(np.float32)
    want = np.asarray(jbox.ltrb_from_locations(jnp.asarray(locs), jnp.asarray(b)))
    got = tbox.ltrb_from_locations(torch.from_numpy(locs), tb)
    assert got.shape == (30, 60, 4)
    np.testing.assert_allclose(got.numpy(), want, **BOX_TOL)

    np.testing.assert_array_equal(tbox.nonempty(tb, 1.0).numpy(),
                                  np.asarray(jbox.nonempty(jnp.asarray(b), 1.0)))
    np.testing.assert_array_equal(tbox.xyxy_to_xywh(tb).numpy(),
                                  np.asarray(jbox.xyxy_to_xywh(jnp.asarray(b))))
    np.testing.assert_array_equal(tbox.xywh_to_xyxy(tbox.xyxy_to_xywh(b)), tbox.xywh_to_xyxy(
        tbox.xyxy_to_xywh(tb)).numpy())


# ---------------------------------------------------------------- matchers
def _match_case(seed=30, n=300, g=8):
    """Integer-pixel anchors and gt with repeated boxes that tie: duplicate
    gt rows, duplicate anchors, anchors equal to a gt box, and padding."""
    rs = np.random.RandomState(seed)
    anchors = int_boxes(rs, (n,), 60, 4, 40)
    gt = int_boxes(rs, (g,), 60, 4, 40)
    gt[1] = gt[0]                        # two gt tie on every anchor: index 0 wins
    anchors[10] = anchors[11] = gt[2]    # two anchors tie at IoU 1 with gt 2
    anchors[20:24] = anchors[24:28]      # repeated anchors share their best gt
    anchors[30] = gt[3] + np.array([2, 0, 2, 0], np.float32)
    anchors[31] = gt[3] - np.array([2, 0, 2, 0], np.float32)   # mirror images tie
    valid = np.ones(g, bool)
    valid[g - 2:] = False
    return anchors, gt, valid


MATCH_RULES = {"retinanet": ([0.4, 0.5], [0, -1, 1]), "rpn": ([0.3, 0.7], [0, -1, 1]),
               "roi_heads": ([0.5], [0, 1])}


@pytest.mark.parametrize("rule", sorted(MATCH_RULES))
@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize("gts", ["padded", "none_valid", "all_valid"])
def test_iou_matcher_equals_jax_exactly(rule, low_quality, gts):
    anchors, gt, valid = _match_case()
    if gts == "none_valid":
        valid[:] = False
    elif gts == "all_valid":
        valid[:] = True
    thresholds, labels = MATCH_RULES[rule]
    want_idx, want_lab = jmatch.iou_matcher(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), thresholds, labels,
        allow_low_quality_matches=low_quality)
    args = (torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid),
            thresholds, labels)
    idx, lab = tmatch.iou_matcher(*args, allow_low_quality_matches=low_quality)
    assert idx.dtype == torch.int32 and lab.dtype == torch.int8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    # streamed over chunks of 64 anchors (300 is no multiple): the same
    cidx, clab = tmatch.iou_matcher(*args, allow_low_quality_matches=low_quality, chunk=64)
    assert torch.equal(cidx, idx) and torch.equal(clab, lab)
    jidx, jlab = jmatch.iou_matcher(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), thresholds, labels,
        allow_low_quality_matches=low_quality, chunk=64)
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(clab.numpy(), np.asarray(jlab))
    if gts == "none_valid":
        assert not idx.any() and (lab == labels[0]).all()
    else:
        assert (idx.numpy() != 1).all()                   # gt 0 and 1 tie: 0 wins
        assert lab[10] == lab[11] == labels[-1]
        assert set(np.unique(lab.numpy())) == set(labels)
        if low_quality:
            # every valid gt holds at least one foreground anchor, ties included
            fg = lab.numpy() == labels[-1]
            assert fg[30] and fg[31]
            assert set(idx.numpy()[fg]) >= set(np.flatnonzero(valid)) - {1}


@pytest.mark.parametrize("k", [1, 4, 400])
def test_topk_matcher_equals_jax_exactly(k):
    anchors, gt, valid = _match_case(seed=31)
    thresholds, labels = MATCH_RULES["rpn"]
    want_idx, want_lab = jmatch.topk_matcher(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), thresholds, labels, k)
    idx, lab = tmatch.topk_matcher(torch.from_numpy(anchors), torch.from_numpy(gt),
                                   torch.from_numpy(valid), thresholds, labels, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    assert (lab.numpy() == 1).sum() >= min(k, 4)
    none = torch.zeros(len(valid), dtype=torch.bool)
    assert (tmatch.topk_matcher(torch.from_numpy(anchors), torch.from_numpy(gt), none,
                                thresholds, labels, k)[1] == 0).all()


@pytest.mark.parametrize("mtype", ["Origin", "TopK"])
def test_build_matcher_follows_the_rpn_config(mtype):
    over = {"MODEL.RPN.MATCHER.TYPE": mtype, "MODEL.RPN.MATCHER.TOPK": 3}
    anchors, gt, valid = _match_case(seed=32)
    want = jmatch.build_matcher(tiny_cfg(jax_get_cfg, **over))(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid))
    got = tmatch.build_matcher(tiny_cfg(torch_get_cfg, **over))(
        torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="matcher"):
        tmatch.build_matcher(tiny_cfg(torch_get_cfg, **{"MODEL.RPN.MATCHER.TYPE": "Best"}))


@pytest.mark.parametrize("pos_num", [1, 3])
def test_rep_points_assign_with_idx_equals_jax_exactly(pos_num):
    """gt boxes whose level clips at both ends of [3, 7] (6 px and 3000 px),
    two gt that claim the same points, a point at equal distance from two
    cells (ties go to the lowest index) and a padded gt."""
    locations, counts = tanchors.fcos_locations((128, 160), (8, 16, 32, 64, 128))
    lvls = np.concatenate([np.full(c, 3 + i, np.int32) for i, c in enumerate(counts)])
    gt = np.array([[10, 10, 16, 16], [0, 0, 3000, 3000], [32, 32, 96, 96], [32, 32, 96, 96],
                   [40, 24, 72, 56], [20, 30, 90, 60], [0, 0, 0, 0], [5, 5, 50, 50]], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    want = jrep.rep_points_assign_with_idx(
        jnp.asarray(locations), jnp.asarray(lvls), jnp.asarray(gt), jnp.asarray(valid), 3, 7,
        pos_num=pos_num)
    got = trep.rep_points_assign_with_idx(
        torch.from_numpy(locations), torch.from_numpy(lvls), torch.from_numpy(gt),
        torch.from_numpy(valid), 3, 7, pos_num=pos_num)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    obj, idx = got[0].numpy(), got[1].numpy()
    picked = set(idx[obj])
    assert {0, 1, 4, 5} <= picked and not picked & {6, 7} and len(picked & {2, 3}) == 1
    assert set(lvls[obj & (idx == 0)]) == {3} and set(lvls[obj & (idx == 1)]) == {7}
    assert obj.sum() <= pos_num * 6


# -------------------------------------------------------------- assignment
ASSIGN_ARCHS = ["RetinaNet", "CenternessRetinaNet", "NearestRetinaNet"]


@pytest.mark.parametrize("arch", ASSIGN_ARCHS + ["PointRetinaNet"])
def test_label_batch_equals_jax_exactly(arch):
    """The three assignment modes on a 128 x 160 input (15 x 20 + ... cells,
    9 anchors each): labels equal everywhere, matched boxes on the
    foreground rows; an image without gt is all background."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")
    assert model.assign_mode == det.assign_mode
    batch = train_batch(seed=40, batch=3, g=8, hw=(128, 160))
    batch["gt_boxes"] = int_boxes(np.random.RandomState(41), (3, 8), 100, 8, 90)
    batch["gt_boxes"][:, 1] = batch["gt_boxes"][:, 0]      # a duplicate gt
    batch["gt_valid"][2] = False
    anchors_np, counts = det._anchors((128, 160))
    want_labels, want_boxes = det._label_batch(
        anchors_np, counts, {k: jnp.asarray(v) for k, v in batch.items()})
    t_anchors, t_counts = model._anchors((128, 160))
    np.testing.assert_array_equal(t_anchors, anchors_np)
    labels, boxes = model._label_batch(
        t_anchors, t_counts, torch.from_numpy(batch["gt_boxes"]),
        torch.from_numpy(batch["gt_classes"]), torch.from_numpy(batch["gt_valid"]))
    want_labels = np.asarray(want_labels)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    fg = (want_labels >= 0) & (want_labels < 80)
    assert fg[:2].sum() > 5 and not fg[2].any() and (want_labels[2] == 80).all()
    np.testing.assert_array_equal(boxes.numpy()[fg], np.asarray(want_boxes)[fg])
    if arch == "RetinaNet":
        assert (want_labels == -1).sum() > 0


def test_retinanet_label_anchors_equals_jax_exactly():
    anchors, gt, valid = _match_case(seed=42)
    classes = np.random.RandomState(43).randint(0, 80, len(gt)).astype(np.int32)
    want = jretina.retinanet_label_anchors(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(classes), jnp.asarray(valid),
        [0.4, 0.5], [0, -1, 1], 80)
    got = tretina.retinanet_label_anchors(
        torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(classes),
        torch.from_numpy(valid), [0.4, 0.5], [0, -1, 1], 80)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert {-1, 80} < set(got[0].tolist())


# ------------------------------------------------------------- model pairs
def _randomize(variables, seed, cls_name=None, cls_std=0.0, cls_bias=0.0):
    """numpy copy of a Flax tree with FrozenBN buffers away from identity
    and, for the predict tests, a classifier that gives scores on both sides
    of the test threshold (the focal prior keeps every score under it)."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    for node in jax.tree_util.tree_leaves(
            out["buffers"], is_leaf=lambda v: isinstance(v, dict) and "scale" in v):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    if cls_name is not None:
        cls = out["params"]["head"][cls_name]
        cls["kernel"] = (rs.randn(*cls["kernel"].shape) * cls_std).astype(np.float32)
        cls["bias"][:] = cls_bias
    return out


@pytest.fixture(scope="module")
def retina_variables():
    """One RetinaNet tree serves every assignment mode and with_anchor."""
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    return _randomize(det.init_variables(jax.random.PRNGKey(0)), seed=50)


def test_bridge_carries_the_retinanet_tree(retina_variables):
    leaves = jax.tree_util.tree_leaves(retina_variables)
    sd = flax_to_state_dict(retina_variables)
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    assert len(sd) == len(leaves) == len(model.state_dict())
    for name in ("head.cls_subnet0.weight", "head.bbox_subnet3.bias", "head.cls_score.weight",
                 "head.bbox_pred.bias", "backbone.top_p6.weight", "backbone.top_p7.bias"):
        assert name in sd, name
    assert sd["head.cls_score.weight"].shape == (9 * 80, 256, 3, 3)
    assert sd["backbone.top_p6.weight"].shape == (256, 512, 3, 3)      # from res5 of R-18
    load_flax_variables(model, retina_variables)
    kernel = retina_variables["params"]["head"]["bbox_pred"]["kernel"]
    np.testing.assert_array_equal(model.head.bbox_pred.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    bad = {"params": {"head": {"cls_subnet9": {"kernel": np.zeros((3, 3, 2, 2))}}}}
    with pytest.raises(KeyError):
        load_flax_variables(model, {**retina_variables, **bad})


def test_fpn_on_res5_and_head_match_jax(retina_variables):
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, retina_variables)
    jvars = jax.tree_util.tree_map(jnp.asarray, retina_variables)
    images = train_batch(seed=51, hw=(64, 96))["image"]
    x = (images.astype(np.float32) - np.asarray(det.cfg.MODEL.PIXEL_MEAN, np.float32))
    x = x / np.asarray(det.cfg.MODEL.PIXEL_STD, np.float32)
    want = det.backbone_spec.module.apply(
        {c: jvars[c]["backbone"] for c in ("params", "buffers")}, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        logits, regs = model(torch.from_numpy(images))
    assert sorted(got) == sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    assert model.backbone.strides == det.backbone_spec.strides
    for k in want:
        assert ratio(got[k].permute(0, 2, 3, 1).numpy(), want[k]) <= 1e-4, k
    want_logits, want_regs = det.module.apply(jvars, jnp.asarray(images))
    cells = [8 * 12, 4 * 6, 2 * 3, 1 * 2, 1 * 1]
    for lvl in range(5):
        assert tuple(logits[lvl].shape) == want_logits[lvl].shape == (2, cells[lvl] * 9, 80)
        assert tuple(regs[lvl].shape) == want_regs[lvl].shape == (2, cells[lvl] * 9, 4)
        np.testing.assert_allclose(logits[lvl].numpy(), np.asarray(want_logits[lvl]), **HEAD_TOL)
        np.testing.assert_allclose(regs[lvl].numpy(), np.asarray(want_regs[lvl]), **HEAD_TOL)


def test_head_rows_follow_the_anchor_order():
    """Anchor ``a`` of cell (y, x) is row ``(y * w + x) * A + a``: a head
    whose cls_score sees only its bias gives each row its anchor's bias."""
    head = tretina.RetinaNetHead(8, num_classes=3, num_anchors=2, num_convs=1)
    with torch.no_grad():
        for p in head.parameters():
            p.zero_()
        head.cls_score.bias.copy_(torch.arange(6.0))        # channel a * C + c
        head.bbox_pred.bias.copy_(torch.arange(8.0))
        logits, regs = head([torch.zeros(1, 8, 2, 3)])
    assert logits[0].shape == (1, 12, 3) and regs[0].shape == (1, 12, 4)
    assert torch.equal(logits[0][0], torch.arange(6.0).view(2, 3).repeat(6, 1))
    assert torch.equal(regs[0][0], torch.arange(8.0).view(2, 4).repeat(6, 1))


@pytest.fixture(scope="module")
def jax_losses(retina_variables):
    """The JAX loss, metrics and gradients of the three assignment modes on
    one batch, and the loss on an all-padded batch."""
    jvars = jax.tree_util.tree_map(jnp.asarray, retina_variables)
    batch = train_batch(seed=52)
    empty = {**batch, "gt_valid": np.zeros_like(batch["gt_valid"])}
    out = {"batch": batch, "empty": empty}
    for arch in ASSIGN_ARCHS:
        det = jax_build_model(tiny_cfg(jax_get_cfg, arch))

        def loss_fn(params, b, det=det):
            return det.loss({"params": params, "buffers": jvars["buffers"]}, b)

        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (total, metrics), grads = fn(jvars["params"],
                                     {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = {
            "total": float(total), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_state_dict(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
        if arch == "RetinaNet":
            (total, metrics), grads = fn(jvars["params"],
                                         {k: jnp.asarray(v) for k, v in empty.items()})
            out["empty_total"] = float(total)
            out["empty_grad_max"] = max(float(jnp.abs(g).max())
                                        for g in jax.tree_util.tree_leaves(grads))
    return out


@pytest.mark.parametrize("arch", ASSIGN_ARCHS)
def test_retinanet_loss_and_gradients_match_jax(arch, retina_variables, jax_losses):
    cfg = tiny_cfg(torch_get_cfg, arch)
    model = torch_build_model(cfg, device="cpu")
    load_flax_variables(model, retina_variables)
    tsolver.build_optimizer(cfg, model)           # applies FREEZE_AT
    want = jax_losses[arch]
    total, metrics = model.loss(jax_losses["batch"])
    assert float(total.detach()) == pytest.approx(want["total"], rel=MODEL_LOSS_RTOL)
    assert sorted(metrics) == sorted(want["metrics"]) == ["loss_box_reg", "loss_cls", "num_pos"]
    for k, v in want["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=MODEL_LOSS_RTOL), k
    assert float(metrics["num_pos"]) > 1
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        assert ratio(p.grad.numpy(), want["grads"][name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"backbone.bottom_up.res4_0.conv1.weight", "backbone.fpn_output0.weight",
            "backbone.top_p6.weight", "head.cls_subnet0.weight", "head.cls_score.bias",
            "head.bbox_pred.weight"} <= checked


def test_all_padded_batch_gives_finite_loss_and_gradients(retina_variables, jax_losses):
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, retina_variables)
    total, metrics = model.loss(jax_losses["empty"])
    assert float(total.detach()) == pytest.approx(jax_losses["empty_total"], rel=MODEL_LOSS_RTOL)
    assert float(metrics["num_pos"]) == 1.0 and float(metrics["loss_box_reg"]) == 0.0
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) == pytest.approx(
        jax_losses["empty_grad_max"], rel=1e-3)
    assert float(model.head.bbox_pred.weight.grad.abs().max()) == 0.0


def predict_batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([[64, 64], [51, 51]], np.float32)}


def assert_detections_equal(got, want, keys):
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    assert got["classes"].dtype == torch.int32 and got["valid"].dtype == torch.bool
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    for k in keys:
        assert tuple(got[k].shape) == want[k].shape == (2, 100, 4)
        np.testing.assert_allclose(got[k].numpy()[valid], want[k][valid], rtol=0, atol=1e-3)


@pytest.mark.usefixtures("default_torch_threads")   # one thread moves it past its tolerance
@pytest.mark.parametrize("arch", ["RetinaNet", "RetinaNetWithAnchor"])
def test_retinanet_predict_matches_jax(arch, retina_variables):
    """A classifier drawn at std 0.005 (logits of std 0.5) with bias -5.1 puts
    about one score in a thousand over SCORE_THRESH_TEST: a few dozen
    detections an image, not none and not the full 100."""
    variables = _randomize(retina_variables, seed=53, cls_name="cls_score", cls_std=0.005,
                           cls_bias=-5.1)
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    assert not det.approx_topk
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")
    load_flax_variables(model, variables)
    batch = predict_batch(54)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = model.predict(batch)
    anchors = ["anchors"] if arch == "RetinaNetWithAnchor" else []
    assert sorted(got) == sorted(want) == sorted(["boxes", "scores", "classes", "valid"] + anchors)
    per_image = want["valid"].sum(1)
    assert (per_image >= 12).all() and (per_image < 100).all(), per_image
    assert_detections_equal(got, want, ["boxes"] + anchors)
    assert (want["scores"][want["valid"]] > 0.05).all()
    if anchors:
        # the second image's anchors are rescaled by 0.8 and clipped to 51 px
        a = got["anchors"].numpy()[1][want["valid"][1]]
        assert a.min() >= 0 and a.max() <= 51


def test_threshold_comes_after_the_top_k():
    """Candidates under the threshold still take their top-k slots: they are
    masked, not replaced by candidates of a lower rank."""
    logits = torch.full((1, 6, 2), -6.0)
    logits[0, :3, 0] = torch.tensor([2.0, 1.0, -2.9])     # sigmoid(-2.9) > 0.05 > sigmoid(-6)
    anchors = torch.tensor([[0.0, 0, 8, 8]]).repeat(6, 1) + torch.arange(6.0)[:, None] * 10
    boxes, scores, classes, valid, sel = tretina._retina_level_candidates(
        logits, torch.zeros(1, 6, 4), anchors, 0.05, 5, (1.0, 1.0, 1.0, 1.0))
    assert boxes.shape == (1, 5, 4) and valid.tolist() == [[True, True, True, False, False]]
    assert classes[0, :3].tolist() == [0, 0, 0]
    assert torch.equal(boxes[0, :3], anchors[:3]) and torch.equal(sel[0, :3], anchors[:3])


# ----------------------------------------------------- the FCOS variants
@pytest.fixture(scope="module")
def fcos_nc_pair():
    """FCOSNCRetinaNet (no centerness conv) in both packages, same weights."""
    arch = "FCOSNCRetinaNet"
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    variables = _randomize(det.init_variables(jax.random.PRNGKey(1)), seed=60)
    assert "centerness" not in variables["params"]["head"]
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")
    assert not hasattr(model.head, "centerness")
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(model.state_dict()) and not any("centerness" in k for k in sd)
    load_flax_variables(model, variables)
    return det, variables, model


def test_fcos_without_centerness_loss_matches_jax(fcos_nc_pair):
    det, variables, model = fcos_nc_pair
    batch = train_batch(seed=61)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        return det.loss({"params": params, "buffers": jvars["buffers"]},
                        {k: jnp.asarray(v) for k, v in batch.items()})

    (want, want_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jvars["params"])
    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    total, metrics = model.loss(batch)
    assert sorted(metrics) == sorted(want_metrics) == ["cls_loss", "num_pos", "reg_loss"]
    assert float(total.detach()) == pytest.approx(float(want), rel=MODEL_LOSS_RTOL)
    for k, v in want_metrics.items():
        assert float(metrics[k].detach()) == pytest.approx(float(v), rel=MODEL_LOSS_RTOL), k
    assert float(metrics["num_pos"]) > 1
    total.backward()
    for name in ("backbone.fpn_output1.weight", "head.bbox_tower3.weight", "head.bbox_pred.weight",
                 "head.scale0.scale", "head.cls_logits.bias"):
        p = dict(model.named_parameters())[name]
        assert ratio(p.grad.numpy(), grads[name].numpy()) <= GRAD_TOL, name


def test_fcos_without_centerness_predict_matches_jax(fcos_nc_pair):
    """Ranked by the raw class score; the score reported is its square root."""
    det, variables, model = fcos_nc_pair
    variables = _randomize(variables, seed=62, cls_name="cls_logits", cls_std=0.05, cls_bias=-3.2)
    load_flax_variables(model, variables)
    batch = predict_batch(63)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = model.predict(batch)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores", "valid"]
    assert (want["valid"].sum(1) >= 5).all()
    assert_detections_equal(got, want, ["boxes"])
    assert (want["scores"][want["valid"]] > 0.05 ** 0.5).all()


def test_fcos_with_anchor_matches_jax():
    arch = "FCOSWithAnchor"
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    assert det.with_anchor
    variables = _randomize(det.init_variables(jax.random.PRNGKey(2)), seed=64,
                           cls_name="cls_logits", cls_std=0.05, cls_bias=-2.0)
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")
    load_flax_variables(model, variables)
    batch = predict_batch(65)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = model.predict(batch)
    assert sorted(got) == sorted(want) == ["anchors", "boxes", "classes", "scores", "valid"]
    assert (want["valid"].sum(1) >= 5).all()
    assert_detections_equal(got, want, ["boxes", "anchors"])
    a = got["anchors"].numpy()[want["valid"]]
    # a degenerate (x, y, x, y) box at a location of the grid over the scale
    np.testing.assert_array_equal(a[:, :2], a[:, 2:])
    first = got["anchors"].numpy()[0][want["valid"][0]]
    assert set(np.unique(first % 4)) == {0.0}


# ---------------------------------------------------------------- registry
def test_registry_holds_the_eleven_names():
    """The eleven names of the FCOS and RetinaNet chassis and the DCN one;
    the rest are Faster R-CNN's (tests/test_torch_rcnn.py), the point-set
    family's (tests/test_torch_reppoints_variants.py) and the ablation
    chassis's and its two FCOS diagnosis detectors' (tests/test_torch_ablation.py,
    tests/test_torch_fcos_anchor.py), the proposal networks'
    (tests/test_torch_proposal.py), FCOSV3 (tests/test_torch_fcosv3.py),
    RotatedRetinaNet (tests/test_torch_rotated_retinanet.py) and CornerNet
    (tests/test_torch_cornernet.py)."""
    chassis = ELEVEN + ["DeformableConvRetinaNet"]
    assert set(chassis) <= set(META_ARCHS) and len(set(chassis)) == 12
    assert set(META_ARCHS) - set(chassis) == {
        "ProposalVisibleRCNN", "GeneralizedRCNN", "ProposalVisibleRCNNWithAnchor",
        "RepPointsDetector", "RepPointsCenterness", "RepPointsV2", "FCOSRepPoints",
        "ReppointsRetinaNet", "FCOSTopK", "FCOSAnchor", "AblationMetaArch",
        "ProposalNetwork", "ProposalNetworkWithMasks", "FCOSV3", "RotatedRetinaNet",
        "CornerNet"}


@pytest.mark.parametrize("arch", ELEVEN)
def test_each_ported_name_builds_on_the_cpu(arch):
    from slenderobjdet_torch.models.meta_arch.fcos import FCOS
    from slenderobjdet_torch.models.meta_arch.retinanet import RetinaNet

    model = torch_build_model(tiny_cfg(torch_get_cfg, arch), device="cpu")
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    assert isinstance(model, RetinaNet if hasattr(det, "assign_mode") else FCOS)
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert model.with_anchor == det.with_anchor == arch.endswith("WithAnchor")
    if isinstance(model, RetinaNet):
        assert model.assign_mode == det.assign_mode
        assert float(model.head.cls_score.bias[0].detach()) == pytest.approx(-np.log(99.0))
        assert float(model.head.cls_subnet0.weight.std()) == pytest.approx(0.01, rel=0.05)
    else:
        assert model.use_centerness == det.use_centerness == (arch != "FCOSNCRetinaNet")
        assert float(model.head.cls_logits.bias[0].detach()) == pytest.approx(-np.log(99.0))


@pytest.mark.parametrize("yaml_name,arch", [
    ("retinanet_R_50_FPN_1x.yaml", "RetinaNet"),
    ("retina_centerness_assign_R_50_FPN_1x.yaml", "CenternessRetinaNet"),
    ("retina_nearest_R_50_FPN_1x.yaml", "NearestRetinaNet"),
    ("retina_fcosv2_R_50_FPN_1x.yaml", "FCOSRetinaNet"),
    ("Base-RetinaNet.yaml", "RetinaNet"),
    ("retinanet_dc_R_50_FPN_1x.yaml", "DeformableConvRetinaNet"),
])
def test_retina_yamls_build_on_the_cpu(yaml_name, arch):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(RETINA / yaml_name))
    assert cfg.MODEL.META_ARCHITECTURE == arch
    cfg.MODEL.RESNETS.DEPTH = 18
    model = torch_build_model(cfg, device="cpu")
    assert type(model).__name__ == arch and model.dtype == torch.bfloat16
    if arch == "DeformableConvRetinaNet":
        from slenderobjdet_torch.models.layers import DFConv2d

        assert isinstance(model.head.cls_subnet0, DFConv2d) and model.head.cls_subnet0.modulated
    assert [n for n, _ in model.backbone.named_children() if n.startswith("top_")] == [
        "top_p6", "top_p7"]


def test_build_model_lists_what_is_available():
    cfg = tiny_cfg(torch_get_cfg, "CenterNet")
    with pytest.raises(KeyError, match="NearestRetinaNet") as err:
        torch_build_model(cfg, device="cpu")
    assert all(name in str(err.value) for name in ELEVEN)


@pytest.mark.parametrize("key", ["TPU.PACK_HEAD_LEVELS"])
def test_unported_retinanet_options_raise(key):
    with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
        torch_build_model(tiny_cfg(torch_get_cfg, **{key: True}), device="cpu")


def test_seeded_init_is_repeatable_and_fcos_draws_are_unchanged():
    """The same generator seed gives the same RetinaNet; FCOS's first draw is
    the stem conv from the generator's first numbers (the order of draws,
    which seeded checkpoints depend on)."""
    cfg = tiny_cfg(torch_get_cfg)
    a = torch_build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = torch_build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    fcos = torch_build_model(tiny_cfg(torch_get_cfg, "FCOS"), device="cpu",
                             generator=torch.Generator().manual_seed(5))
    w = fcos.backbone.bottom_up.stem_conv1.weight.detach()
    want = torch.randn(w.shape, generator=torch.Generator().manual_seed(5)) * (1.0 / 147 ** 0.5)
    assert torch.equal(w, want)
    assert torch.equal(a.backbone.bottom_up.stem_conv1.weight.detach(), want)
