"""The PyTorch port's Faster R-CNN (``ProposalVisibleRCNN`` with FPN) held
against the JAX package on the CPU, in float32 at a tiny size (R-18, 64 x 64
images, 8 padded gt):

- ``subsample_labels`` and ``sample_proposals`` exactly, fed the JAX
  package's own priorities; the RPN's anchors bit for bit; FPN level
  assignment exactly; both multilevel poolers (forward 1e-5, the feature
  gradient against the JAX custom VJP 1e-4);
- the RPN's level-split NMS route, run with the plain NMS, against the JAX
  package's single ``batched_nms``, bit for bit on integer-pixel boxes with
  tied scores, at a tiny size and at 8,924 candidates with 1,000 slots (and
  the kernel's algorithm on those rows);
- the RPN and ROI losses (1e-4) with the JAX priorities; the whole model's
  loss (1e-4) and gradients (1e-3) with every candidate sampled; predict,
  detections and proposals slot for slot, with and without anchors;
- ``train_net_torch.main`` over 4 steps against the JAX trainer, and with
  sampling on, a resumed run bit-equal to an uninterrupted one.

Both packages get the same weights through ``checkpoint/bridge.py``; every
input is made from a numpy seed inside its test.
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
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import anchors as tanchors  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models import sampling as tsampling  # noqa: E402
from slenderobjdet_torch.models.roi_heads import roi_heads as troi  # noqa: E402
from slenderobjdet_torch.ops import nms as tnms  # noqa: E402
from slenderobjdet_torch.ops import roi_align as tra  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402
from slenderobjdet_tpu.engine import trainer as jtrainer  # noqa: E402
from slenderobjdet_tpu.models import anchors as janchors  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models import sampling as jsampling  # noqa: E402
from slenderobjdet_tpu.models.roi_heads import roi_heads as jroi  # noqa: E402
from slenderobjdet_tpu.ops import nms as jnms  # noqa: E402
from slenderobjdet_tpu.ops import roi_align as jra  # noqa: E402
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"
POOL_TOL = 1e-5          # pooled features, fp32
POOL_GRAD_TOL = 1e-4     # the pooler's feature gradient, fp32
LOSS_RTOL = 1e-4         # RPN, ROI and whole-model losses
GRAD_TOL = 1e-3          # per tensor, max |diff| / max |JAX gradient|
BOX_ATOL = 1e-3          # predicted boxes, proposals and anchors, pixels
SCORE_ATOL = 1e-5
FOURTEEN = ["FCOS", "FCOSV2", "GroupNet", "FCOSWithAnchor", "FCOSRetinaNet",
            "FCOSNCRetinaNet", "RetinaNet", "RetinaNetWithAnchor", "CenternessRetinaNet",
            "NearestRetinaNet", "PointRetinaNet", "ProposalVisibleRCNN", "GeneralizedRCNN",
            "ProposalVisibleRCNNWithAnchor"]
# every candidate sampled, so that no draw enters (64 x 64: 1023 anchors,
# the trainer's padded batches up to 160 x 160: 6402; 100 proposals + 10 gt)
SELECT_ALL = {"MODEL.RPN.BATCH_SIZE_PER_IMAGE": 8192,
              "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 512}


def tiny_cfg(get_cfg, arch="ProposalVisibleRCNN", **overrides):
    """The Faster R-CNN YAML at R-18 in fp32 with the JAX tests' small
    top-k (tests/test_model_rcnn.py)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 50
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def int_boxes(rs, shape, span, lo, hi):
    xy = rs.randint(0, span, (*shape, 2))
    return np.concatenate([xy, xy + rs.randint(lo, hi, (*shape, 2))], -1).astype(np.float32)


def jax_priorities(rng, n):
    """The two priority vectors ``jax subsample_labels(rng, ...)`` draws."""
    r1, r2 = jax.random.split(rng)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(r, (n,)))) for r in (r1, r2))


def per_image_priorities(rng, batch, n):
    """The priorities of a JAX loss that splits ``rng`` into one key an image."""
    return [jax_priorities(r, n) for r in jax.random.split(rng, batch)]


def batch_of(seed, batch=2, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, 8), bool)
    valid[:, 6:] = False
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": int_boxes(rs, (batch, 8), 40, 6, 30),
            "gt_classes": rs.randint(0, 80, (batch, 8)).astype(np.int32),
            "gt_valid": valid,
            "image_size": np.array([[64, 64], [60, 50]], np.int32)[:batch]}


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("n,num_samples,fraction,share", [
    (300, 64, 0.25, 0.3), (1023, 256, 0.5, 0.05), (50, 512, 0.25, 0.5), (200, 16, 0.5, 0.9)])
def test_subsample_labels_equals_jax_exactly(n, num_samples, fraction, share):
    rs = np.random.RandomState(n + num_samples)
    labels = np.where(rs.rand(n) < share, 1, np.where(rs.rand(n) < 0.8, 0, -1))
    pos, neg = labels == 1, labels == 0
    rng = jax.random.PRNGKey(n)
    want = jsampling.subsample_labels(rng, jnp.asarray(pos), jnp.asarray(neg), num_samples,
                                      fraction)
    got = tsampling.subsample_labels(torch.from_numpy(pos), torch.from_numpy(neg), num_samples,
                                     fraction, priorities=jax_priorities(rng, n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) == min(pos.sum(), int(num_samples * fraction))
    assert int(got[1].sum()) == min(neg.sum(), num_samples - int(got[0].sum()))
    # from a generator: the same counts, a different draw
    drawn = tsampling.subsample_labels(torch.from_numpy(pos), torch.from_numpy(neg), num_samples,
                                       fraction, generator=torch.Generator().manual_seed(0))
    assert [int(t.sum()) for t in drawn] == [int(t.sum()) for t in got]


@pytest.mark.parametrize("num_samples", [16, 64, 512])
def test_sample_proposals_equals_jax_exactly(num_samples):
    """Proposals near the gt (positives and negatives), invalid proposals, a
    duplicate gt and padded gt; 64 rows at 0.25 draw, 512 takes all."""
    rs = np.random.RandomState(num_samples)
    gt = int_boxes(rs, (8,), 50, 8, 40)
    gt[1] = gt[0]
    gt_valid = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    props = np.concatenate([gt[rs.randint(0, 6, 60)] + rs.randint(-6, 7, (60, 4)),
                            int_boxes(rs, (40,), 60, 4, 40)]).astype(np.float32)
    prop_valid = rs.rand(100) < 0.9
    classes = rs.randint(0, 80, 8).astype(np.int32)
    rng = jax.random.PRNGKey(7 + num_samples)
    args = (props, prop_valid, gt, classes, gt_valid)
    want = jroi.sample_proposals(rng, *map(jnp.asarray, args), num_samples, 0.25, [0.5], [0, 1],
                                 80)
    got = troi.sample_proposals(*map(torch.from_numpy, args), num_samples, 0.25, [0.5], [0, 1],
                                80, priorities=jax_priorities(rng, 108))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rois, cls, _, row_valid = got
    assert rois.shape == (min(num_samples, 108), 4) and cls.dtype == torch.int32
    assert 0 < int((cls < 80).sum()) and int(row_valid.sum()) > int((cls < 80).sum())
    assert (cls[~row_valid] == 80).all()


# ------------------------------------------------------- anchors and levels
@pytest.mark.parametrize("image_hw,candidates", [
    ((64, 64), 1023), ((896, 1408), 8924), ((1408, 896), 8924), ((800, 1344), 8819)])
def test_rpn_anchors_equal_the_jax_packages_bit_for_bit(image_hw, candidates):
    """``AnchorGeneratorSpec`` of the Faster R-CNN YAML (5 levels, 3 shapes a
    cell), and the RPN's training candidates: min(2000, count) a level."""
    strides = [4, 8, 16, 32, 64]
    cfg_j, cfg_t = jax_get_cfg(), torch_get_cfg()
    for cfg in (cfg_j, cfg_t):
        cfg.merge_from_file(str(CONFIG))
    want = janchors.AnchorGeneratorSpec(cfg_j, strides)
    got = tanchors.AnchorGeneratorSpec(cfg_t, strides)
    assert got.num_cell_anchors == want.num_cell_anchors == [3] * 5
    (ga, gc), (wa, wc) = got.anchors(image_hw), want.anchors(image_hw)
    assert gc == wc and ga.dtype == wa.dtype == np.float32
    np.testing.assert_array_equal(ga, wa)
    pre = cfg_t.MODEL.RPN.PRE_NMS_TOPK_TRAIN
    assert sum(min(pre, c) for c in gc) == (candidates if image_hw != (64, 64) else sum(gc))


def test_assign_fpn_levels_equals_jax_exactly():
    """Squares at the canonical sizes and their halves and doubles (log2 on
    the integer), degenerate boxes, and random integer-pixel boxes."""
    rs = np.random.RandomState(3)
    sides = np.array([28, 56, 111, 112, 113, 223, 224, 225, 447, 448, 449, 896, 1792])
    squares = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides, sides], 1)
    flat = np.array([[5, 5, 5, 90], [10, 10, 4, 4]])
    rois = np.concatenate([squares, flat, int_boxes(rs, (500,), 900, 1, 600)]).astype(np.float32)
    want = np.asarray(jra.assign_fpn_levels(jnp.asarray(rois), 2, 5))
    got = tra.assign_fpn_levels(torch.from_numpy(rois), 2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {2, 3, 4, 5}
    assert want[:13].tolist() == [2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5]


# ------------------------------------------------------------------ poolers
@pytest.fixture(scope="module")
def pool_case():
    rs = np.random.RandomState(5)
    strides, shapes = [4, 8, 16, 32], [(24, 32), (12, 16), (6, 8), (3, 4)]
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in shapes]
    rois = int_boxes(rs, (2, 60), 120, 2, 600) + rs.rand(2, 60, 4).astype(np.float32)
    rois[:, :3] = [[-20, -10, 5, 3], [90, 100, 400, 300], [0, 0, 128, 96]]   # off the map
    return strides, feats, rois


@pytest.mark.parametrize("name", ["fused", "train"])
def test_multilevel_poolers_match_jax(pool_case, name):
    """Forward at 1e-5 and the feature gradient against the JAX custom VJP
    (the train pooler's; the predict pooler's is XLA's) at 1e-4, in fp32,
    every level used, RoIs over the map's border included."""
    strides, feats, rois = pool_case
    jfn = getattr(jra, f"multilevel_roi_align_{name}")
    tfn = getattr(tra, f"multilevel_roi_align_{name}")
    levels = np.asarray(jra.assign_fpn_levels(jnp.asarray(rois.reshape(-1, 4)), 2, 5))
    assert set(levels.tolist()) == {2, 3, 4, 5}

    def jax_pool(*fs):
        return jax.vmap(lambda *a: jfn(list(a[:-1]), strides, a[-1], 7, 2))(
            *fs, jnp.asarray(rois))

    want = np.asarray(jax_pool(*map(jnp.asarray, feats)))
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    got = tfn(tf, strides, torch.from_numpy(rois), 7, 2, roi_chunk=32)
    assert got.shape == want.shape == (2, 60, 7, 7, 16) and got.dtype == torch.float32
    assert ratio(got.detach().numpy(), want) <= POOL_TOL
    cot = np.random.RandomState(6).randn(*want.shape).astype(np.float32)
    grads = jax.grad(lambda *fs: jnp.sum(jax_pool(*fs) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, feats))
    (got * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(tf, grads):
        assert float(np.abs(np.asarray(g)).max()) > 0
        assert ratio(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g)) <= POOL_GRAD_TOL


def test_single_level_roi_align_matches_jax(pool_case):
    strides, feats, rois = pool_case
    want = jra.roi_align(jnp.asarray(feats[1][0]), jnp.asarray(rois[0]), 1 / 8, 7, 2,
                         roi_chunk=16)
    got = tra.roi_align(torch.from_numpy(feats[1][0]), torch.from_numpy(rois[0]), 1 / 8, 7, 2,
                        roi_chunk=16)
    assert ratio(got.numpy(), np.asarray(want)) <= POOL_TOL


# --------------------------------------------------------------------- NMS
def rpn_candidates(seed, batch, counts, span, steps):
    """Integer-pixel boxes clipped to [0, span], scores in ``steps`` steps
    (ties), a validity mask."""
    rs = np.random.RandomState(seed)
    n = sum(counts)
    boxes = np.clip(int_boxes(rs, (batch, n), span, 2, span // 4), 0, span)
    scores = (np.floor(rs.rand(batch, n) * steps) / steps).astype(np.float32)
    valid = rs.rand(batch, n) < 0.9
    return boxes, scores, valid


def jax_level_nms(boxes, scores, valid, counts, thr, max_out):
    levels = np.concatenate([np.full(c, i, np.int32) for i, c in enumerate(counts)])
    fn = jax.jit(jax.vmap(lambda b, s, v: jnp.stack(
        jnms.batched_nms(b, s, jnp.asarray(levels), thr, max_out, valid=v))))
    out = np.asarray(fn(*map(jnp.asarray, (boxes, scores, valid))))
    return out[:, 0], out[:, 1].astype(bool)


@pytest.mark.parametrize("counts,max_out,span,steps", [
    ([30, 20, 7], 16, 60, 4), ([30, 20, 7], 64, 60, 8), ([2000] * 4 + [924], 1000, 1400, 64)])
def test_level_nms_route_equals_jax_batched_nms_bit_for_bit(counts, max_out, span, steps):
    """The RPN's route (rows of (image, level), the plain NMS on each, the
    merge) against one JAX ``batched_nms`` with the level as the class; at
    8,924 candidates and 1,000 slots (the RPN's training shape at the loader's
    896 x 1408) too. There the kernel's algorithm (``grouped_nms_model``:
    32 a round, the 1024-position window) also keeps what the plain NMS keeps
    on each row."""
    boxes, scores, valid = rpn_candidates(sum(counts) + max_out, 2, counts, span, steps)
    want_idx, want_valid = jax_level_nms(boxes, scores, valid, counts, 0.7, max_out)
    got_idx, got_valid = tnms.level_batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), counts, 0.7, max_out,
        valid=torch.from_numpy(valid))
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    kept = want_valid.sum(1)
    assert (kept > max_out // 2).all()
    if max_out == 1000:
        assert (kept == 1000).all()
        # the kernel's algorithm on the first image's rows, each shifted by its offset
        off = np.arange(5, dtype=np.float32) * (boxes[0].max() + np.float32(1))
        start = np.concatenate([[0], np.cumsum(counts)])
        rows = [slice(start[i], start[i + 1]) for i in range(5)]
        pad = max(counts)

        def stacked(a, fill):
            return torch.from_numpy(np.stack([np.concatenate(
                [a[0][r], np.full((pad - (r.stop - r.start),) + a.shape[2:], fill, a.dtype)])
                for r in rows]))

        rb = stacked(boxes, 0) + torch.from_numpy(off)[:, None, None]
        rs_, rv = stacked(scores, 0), stacked(valid, False)
        model_idx, model_valid, rounds = tnms.grouped_nms_model(rb, rs_, 0.7, 1000, rv)
        plain_idx, plain_valid = tnms.nms_select(rb, rs_, 0.7, 1000, rv)
        assert torch.equal(model_idx, plain_idx) and torch.equal(model_valid, plain_valid)
        assert int(rounds.min()) >= 1 and int(plain_valid[:4].sum(1).min()) > 500


# --------------------------------------------------------------- the model
def _randomize(variables, seed):
    """numpy copy of the Flax tree with FrozenBN away from identity, the
    regression layers scaled down, so that proposals and boxes are not all
    at the decoding clamp, and the classifier too, so that few scores
    saturate at 1."""
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
def rcnn_pair():
    det = jax_build_model(tiny_cfg(jax_get_cfg, **SELECT_ALL))
    variables = _randomize(det.init_variables(jax.random.PRNGKey(0)), seed=8)
    return det, variables


def torch_model(variables, arch="ProposalVisibleRCNN", **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def test_bridge_carries_the_rcnn_tree(rcnn_pair):
    _, variables = rcnn_pair
    sd = flax_to_state_dict(variables)
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert sd["rpn_head.conv.weight"].shape == (256, 256, 3, 3)
    assert sd["rpn_head.objectness_logits.weight"].shape == (3, 256, 1, 1)
    assert sd["roi_box.head.fc1.weight"].shape == (1024, 7 * 7 * 256)
    assert sd["roi_box.outputs.bbox_pred.weight"].shape == (320, 1024)
    load_flax_variables(model, variables)
    kernel = variables["params"]["roi_box"]["head"]["fc1"]["kernel"]
    np.testing.assert_array_equal(model.roi_box.head.fc1.weight.detach().numpy(), kernel.T)
    # fc1's inputs are in (P, P, C) order on both sides: one pooled row
    # through the Flax Dense and through the port's layer
    x = np.random.RandomState(9).randn(7, 7, 256).astype(np.float32)
    want = x.reshape(-1) @ kernel + variables["params"]["roi_box"]["head"]["fc1"]["bias"]
    got = model.roi_box.head.fc1(model.roi_box.head.fc1.weight.new_tensor(x).flatten())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


def test_rpn_losses_match_jax_with_its_draws(rcnn_pair):
    """The RPN's 256 at 0.5 subsampling with JAX's priorities: losses at
    1e-4; the same weights and images as the model, the head's outputs as
    inputs."""
    det, variables = rcnn_pair
    model = torch_model(variables, **{"MODEL.RPN.BATCH_SIZE_PER_IMAGE": 256})
    batch = batch_of(10)
    with torch.no_grad():
        logits_l, deltas_l, _ = model(torch.from_numpy(batch["image"]))
    logits, deltas = torch.cat(logits_l, 1), torch.cat(deltas_l, 1)
    anchors, _ = model.rpn_anchors((64, 64))
    rng = jax.random.PRNGKey(11)
    jdet = jax_build_model(tiny_cfg(jax_get_cfg))
    want = jdet.rpn.losses(rng, jnp.asarray(anchors.numpy()), jnp.asarray(logits.numpy()),
                           jnp.asarray(deltas.numpy()),
                           *map(jnp.asarray, (batch["gt_boxes"], batch["gt_classes"],
                                              batch["gt_valid"])))
    got = model.rpn.losses(anchors, logits, deltas,
                           *map(torch.from_numpy, (batch["gt_boxes"], batch["gt_classes"],
                                                   batch["gt_valid"])),
                           priorities=per_image_priorities(rng, 2, anchors.shape[0]))
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
        assert float(got[k]) > 0


def test_roi_losses_match_jax_with_its_draws(rcnn_pair):
    """The ROI heads' 16 at 0.25 subsampling (of 100 proposals and 8 gt)
    with JAX's priorities: losses at 1e-4, num_fg exactly."""
    det, variables = rcnn_pair
    model = torch_model(variables, **{"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16})
    jdet = jax_build_model(tiny_cfg(jax_get_cfg, **{"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16}))
    rs = np.random.RandomState(12)
    feats = [rs.randn(2, 64 // s, 64 // s, 256).astype(np.float32) for s in (4, 8, 16, 32)]
    batch = batch_of(13)
    gt = batch["gt_boxes"]
    props = np.concatenate([gt[:, rs.randint(0, 6, 60)] + rs.randint(-5, 6, (2, 60, 4)),
                            int_boxes(rs, (2, 40), 50, 4, 40)], 1).astype(np.float32)
    prop_valid = rs.rand(2, 100) < 0.9
    rng = jax.random.PRNGKey(14)
    gts = (batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"])
    want = jdet.roi_heads.losses(rng, {"params": variables["params"]["roi_box"]},
                                 list(map(jnp.asarray, feats)), jnp.asarray(props),
                                 jnp.asarray(prop_valid), *map(jnp.asarray, gts))
    got = model.roi_heads.losses(
        model.roi_box, [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
        torch.from_numpy(props), torch.from_numpy(prop_valid), *map(torch.from_numpy, gts),
        priorities=per_image_priorities(rng, 2, 108))
    for k in ("loss_cls", "loss_box_reg"):
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
    assert int(got["num_fg"]) == int(want["num_fg"]) > 2


def test_rcnn_loss_and_gradients_match_jax(rcnn_pair):
    """Every candidate sampled: the four losses at 1e-4 and every trained
    tensor's gradient at 1e-3 of its largest entry."""
    det, variables = rcnn_pair
    from slenderobjdet_torch.solver import build as tsolver

    cfg = tiny_cfg(torch_get_cfg, **SELECT_ALL)
    model = torch_model(variables, **SELECT_ALL)
    tsolver.build_optimizer(cfg, model)          # applies FREEZE_AT
    batch = batch_of(15)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        return det.loss({**jvars, "params": params}, {k: jnp.asarray(v) for k, v in batch.items()})

    (want, want_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jvars["params"])
    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
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
    assert {"backbone.bottom_up.res4_0.conv1.weight", "backbone.fpn_output0.weight",
            "rpn_head.conv.weight", "rpn_head.anchor_deltas.bias",
            "roi_box.head.fc1.weight", "roi_box.outputs.cls_score.bias"} <= checked


def predict_batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([[64, 64], [51, 51]], np.float32),
            "image_size": np.array([[64, 64], [60, 52]], np.int32)}


@pytest.mark.usefixtures("default_torch_threads")   # one thread moves it past its tolerance
@pytest.mark.parametrize("arch", ["ProposalVisibleRCNN", "ProposalVisibleRCNNWithAnchor"])
def test_rcnn_predict_matches_jax(rcnn_pair, arch):
    """Detections and proposals slot for slot: validity and classes exactly,
    scores at 1e-5 (the proposals' logits relative), boxes at 1e-3 px; the
    second image's proposals are clipped to its unpadded 60 x 52."""
    _, variables = rcnn_pair
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch))
    model = torch_model(variables, arch)
    assert model.with_anchor == det.with_anchor == arch.endswith("WithAnchor")
    batch = predict_batch(16)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = model.predict(batch)
    extra = ["anchors", "det_proposals", "proposal_anchors"] if model.with_anchor else []
    assert sorted(got) == sorted(want) == sorted(
        ["boxes", "scores", "classes", "valid", "proposals", "proposal_scores",
         "proposal_valid"] + extra)
    for k in ("valid", "proposal_valid", "classes"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["classes"].dtype == torch.int32
    assert 0 < want["valid"].sum() < 200 and want["proposal_valid"].sum() > 40
    v = want["valid"]
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v], rtol=0,
                               atol=SCORE_ATOL)
    # the RPN's logits, of size ~30 on these weights
    np.testing.assert_allclose(got["proposal_scores"].numpy(), want["proposal_scores"],
                               rtol=SCORE_ATOL, atol=SCORE_ATOL)
    for k in ["boxes", "proposals"] + extra:
        mask = want["proposal_valid"] if k.startswith("proposal") else v
        np.testing.assert_allclose(got[k].numpy()[mask], want[k][mask], rtol=0, atol=BOX_ATOL,
                                   err_msg=k)
    p = got["proposals"].numpy()[1] * 0.8
    assert p[..., 0::2].max() <= 52 + 1e-4 and p[..., 1::2].max() <= 60 + 1e-4


# ---------------------------------------------------------------- registry
def test_registry_holds_the_fourteen_names():
    """The fourteen names of the earlier chassis, the six of deformable
    convolution and the point-set family, and the ablation chassis with its
    two FCOS diagnosis detectors, the two proposal networks, FCOSV3,
    RotatedRetinaNet and CornerNet."""
    assert sorted(META_ARCHS) == sorted(FOURTEEN + [
        "DeformableConvRetinaNet", "RepPointsDetector", "RepPointsCenterness", "RepPointsV2",
        "FCOSRepPoints", "ReppointsRetinaNet", "AblationMetaArch", "FCOSTopK", "FCOSAnchor",
        "ProposalNetwork", "ProposalNetworkWithMasks", "FCOSV3", "RotatedRetinaNet",
        "CornerNet"])


@pytest.mark.parametrize("arch", ["ProposalVisibleRCNN", "GeneralizedRCNN",
                                  "ProposalVisibleRCNNWithAnchor"])
def test_rcnn_names_build_from_the_yaml(arch):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.RESNETS.DEPTH = 18
    model = torch_build_model(cfg, device="cpu")
    assert type(model).__name__ == "ProposalVisibleRCNN" and model.dtype == torch.bfloat16
    assert model.with_anchor == arch.endswith("WithAnchor")
    assert all(p.device.type == "cpu" for p in model.parameters())
    for weight, std in ((model.rpn_head.conv.weight, 0.01),
                        (model.roi_box.outputs.bbox_pred.weight, 0.001),
                        (model.roi_box.head.fc1.weight, 12544 ** -0.5)):
        assert float(weight.detach().std()) == pytest.approx(std, rel=0.05)
    assert model.rpn.post_nms_topk == {True: 1000, False: 1000}


# ------------------------------------------------------------------ trainer
NAME = "torch_rcnn_synth"
TINY = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.ROI_HEADS.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.PRE_NMS_TOPK_TEST": 100,
    "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100, "MODEL.RPN.POST_NMS_TOPK_TEST": 50,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_rcnn")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    return tmp


def make_cfg(get_cfg, out, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    opts = {**TINY, "OUTPUT_DIR": str(out), **overrides}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def cli_args(out, *flags, **overrides):
    opts = {**TINY, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(CONFIG), *flags] + [str(x) for kv in opts.items() for x in kv])


def test_rcnn_main_matches_the_jax_trainer_over_four_steps(synth, monkeypatch):
    """``train_net_torch.main`` on the Faster R-CNN YAML from the JAX
    trainer's initial weights, every candidate sampled: the same losses a
    step, to the one-step tolerance, and the same parameters after 4 steps;
    then the evaluation, which passes ``image_size`` to ``predict``."""
    steps = 4
    # BASE_LR 1e-5: the random R-18's box head starts at a softmax loss near
    # 74, and at 1e-4 the two trainers' steps move the RPN's logits apart
    # enough by step 3 that a proposal near the top-k cut differs
    over = {**SELECT_ALL, "SOLVER.MAX_ITER": steps, "SOLVER.WARMUP_ITERS": 0,
            "SOLVER.BASE_LR": 1e-5, "DATASETS.TEST": ()}
    jt = jtrainer.BaseTrainer(make_cfg(jax_get_cfg, synth / "jax_out", **over))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get({"params": jt.state.params, "buffers": jt.state.buffers}))
    jax_losses, jax_step = [], jt.train_step

    def recording_jax_step(state, batch):
        state, metrics = jax_step(state, batch)
        jax_losses.append(metrics)
        return state, metrics

    jt.train_step = recording_jax_step
    jt.train()
    want_params = flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.params))})

    weights = synth / "rcnn_init.pth"
    torch.save({"model": flax_to_state_dict(variables), "iteration": 0}, weights)
    torch_losses, trainers, predicted = [], [], []
    real_call, real_train = TrainStep.__call__, ttrainer.BaseTrainer.train

    def recording_call(self, batch):
        assert isinstance(batch["generator"], torch.Generator)
        out = real_call(self, batch)
        torch_losses.append(out)
        return out

    def recording_train(self):
        trainers.append(self)
        real_predict = self.model.predict

        def recording_predict(batch):
            predicted.append(sorted(batch))
            return real_predict(batch)

        self.model.predict = recording_predict
        return real_train(self)

    monkeypatch.setattr(TrainStep, "__call__", recording_call)
    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    results = train_net_torch.main(cli_args(synth / "torch_out", "--device", "cpu", **{
        **over, "MODEL.WEIGHTS": str(weights), "DATASETS.TEST": (NAME,)}))
    model = trainers[0].model
    assert len(torch_losses) == len(jax_losses) == steps
    for i, (g, w) in enumerate(zip(torch_losses, jax_losses)):
        assert sorted(g) == ["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc",
                             "num_fg", "total_loss"]
        for k in g:
            assert float(g[k]) == pytest.approx(float(w[k]), rel=LOSS_RTOL), (i, k)
    assert float(torch_losses[-1]["total_loss"]) < float(torch_losses[0]["total_loss"])
    old = flax_to_state_dict(variables)
    moved = 0
    for name, p in model.named_parameters():
        want = want_params[name].numpy()
        update = np.abs(want - old[name].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max() + 0.05 * update,
                                   err_msg=name)
        moved += not torch.equal(p.detach(), old[name])
    assert moved > 40
    assert predicted and all(k == ["image", "image_size", "orig_size", "scale"]
                             for k in predicted)
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"])


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


def test_rcnn_resumed_run_is_bit_equal_to_the_uninterrupted_run(synth, monkeypatch):
    """With sampling on (RPN 64 of 1000-odd anchors, ROI 16 of 100-odd
    rows), 2 iterations and a checkpoint, ``--resume`` to 4, against a run
    that went 0 -> 4 on the same batches: the same state bit for bit, because
    each step's generator comes from the seed and the iteration only."""
    k, n = 2, 4
    over = {"MODEL.RPN.BATCH_SIZE_PER_IMAGE": 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16,
            "SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 3, "DATASETS.TEST": ()}
    trainers, draws = [], []
    real_train, real_call = ttrainer.BaseTrainer.train, TrainStep.__call__

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    def recording_call(self, batch):
        draws.append(batch["generator"].initial_seed())
        return real_call(self, batch)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    monkeypatch.setattr(TrainStep, "__call__", recording_call)
    out = synth / "rcnn_resumed"
    train_net_torch.main(cli_args(out, "--device", "cpu", **over, **{"SOLVER.MAX_ITER": k}))
    train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", **over,
                                  **{"SOLVER.MAX_ITER": n}))
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
    train_net_torch.main(cli_args(synth / "rcnn_straight", "--device", "cpu", **over,
                                  **{"SOLVER.MAX_ITER": n}))
    assert draws[:n] == draws[n:] and len(set(draws)) == n
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    _states_equal(got, want)
