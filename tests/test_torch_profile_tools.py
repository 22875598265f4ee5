"""The port's staged profile tools against the JAX package on the CPU.

``slenderobjdet_torch/tools/{predict_profile,postprocess_probe,
profile_backbone,rcnn_profile,reppoints_profile,corner_profile}.py`` time
stages of a predict call. Here each stage they time is held against the
JAX package's own functions on the same seeded numpy inputs and, where a
model runs, the same weights (drawn in numpy on ``jax.eval_shape`` and
carried by ``checkpoint/bridge.py``), at the tiny shapes of
``tests/conftest.py`` (R-18, float32, 64 x 64, B = 2):

- ``postprocess_probe``: ``_fcos_level_candidates`` per level with the exact
  top-k on both sides (classes, locations and validity exactly, boxes and
  scores within ``BOX_ATOL`` / ``SCORE_ATOL``); the NMS's keep sets exactly
  on integer-pixel boxes (JAX ``batched_nms`` under ``vmap``; the port's
  ``cuda_batched_nms`` takes its plain version on CPU tensors);
- ``predict_profile``: the flagship at R-18, ``fwd`` within ``FEATURE_TOL``
  and ``fwd+cand`` (the port's candidates of the JAX head outputs, exactly);
- ``profile_backbone``: ``conv_flops`` and the stage FLOP sums equal the JAX
  script's; the stem module and the res2 stage within ``FEATURE_TOL`` of
  the JAX script's ``Stem`` and ``Stage`` (written here: the script defines
  them inside ``main``);
- ``rcnn_profile``: the forward, the proposals (on the JAX head outputs),
  the pooled features of both poolers and the box head's outputs;
- ``reppoints_profile``: the trunk and FPN, and ``deform_sample_batched``;
- ``corner_profile``: ``corner_decode`` cut after the top-k, the pairing and
  the NMS, against the JAX script's decode closure written here in JAX on
  seeded head outputs.

Then each tool's ``main(["--device", "cpu", ...])`` at a tiny size (its
module-level config and size hooks patched): it prints the JAX script's
labels in order and launches no kernel. No time is compared.
"""

import contextlib
import importlib.util
import io
import math
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.checkpoint.bridge import (load_flax_variables, manifest_of,
                                                   seeded_flax_variables)
from slenderobjdet_torch.tools import (_profile, corner_profile, postprocess_probe,
                                       predict_profile, profile_backbone, rcnn_profile,
                                       reppoints_profile)
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.models import build_model as jax_build_model
from slenderobjdet_tpu.models.backbones.resnet import BottleneckBlock as JaxBottleneck
from slenderobjdet_tpu.models.meta_arch.fcos import _fcos_level_candidates as jax_level_candidates
from slenderobjdet_tpu.ops.deform_conv import deform_sample_batched as jax_deform_sample
from slenderobjdet_tpu.ops.nms import batched_nms as jax_batched_nms
from torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]
HW = (64, 64)
BATCH = 2
FEATURE_TOL = 1e-4     # max |diff| / max |JAX|: fp32, different conv sum orders
POOL_TOL = 1e-5        # the poolers and the box head on the same inputs
GATHER_TOL = 1e-6      # the same bilinear taps on the same inputs
BOX_ATOL = 1e-4        # px, decoded candidates (coordinates up to ~300)
SCORE_ATOL = 1e-6
R18 = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32", "TPU.APPROX_TOPK", "False"]
# the R-CNN tests' small top-k (tests/test_torch_rcnn.py)
RCNN_TINY = [*R18, "MODEL.RPN.PRE_NMS_TOPK_TEST", "100", "MODEL.RPN.POST_NMS_TOPK_TEST", "50"]
CORNER_TINY = ["MODEL.HOURGLASS.DEPTH_BLOCK", "3", "MODEL.HOURGLASS.CHANNELS_BLOCK",
               "[64, 64, 96, 96]", "MODEL.HOURGLASS.NUM_CONV_BLOCK", "[1, 1, 1, 2]",
               "MODEL.CORNER_NET.NUM_CLASSES", "8", "TPU.COMPUTE_DTYPE", "float32",
               "TPU.APPROX_TOPK", "False"]


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def nhwc(t):
    """A port feature map (B, C, H, W) as numpy NHWC."""
    return t.permute(0, 2, 3, 1).numpy()


def nchw(a):
    """A JAX NHWC map as a torch (B, C, H, W) view in channels-last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def rule(name, shape):
    """He-normal kernels, FrozenBN away from identity, zero biases."""
    leaf = name.rsplit("/", 1)[-1]
    if name.startswith("buffers/"):
        return {"scale": "frozen_bn_scale", "bias": "frozen_bn_bias"}.get(leaf, "ones")
    return {"kernel": "he_normal", "bias": "zeros"}.get(leaf, "ones")


def build_pair(yaml, overrides, seed, edit=None):
    """(JAX detector, its jnp variables, the port's model with the same
    weights) for ``yaml`` with ``overrides``; ``edit`` may change the drawn
    numpy tree first."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(ROOT / yaml))
    jcfg.merge_from_list(list(overrides))
    jcfg.freeze()
    det = jax_build_model(jcfg)
    variables = seeded_flax_variables(
        manifest_of(jax.eval_shape(det.init_variables, jax.random.PRNGKey(0)), rule), seed)
    if edit is not None:
        edit(variables)
    model = _profile.seeded_model(_profile.load_cfg(yaml, overrides), torch.device("cpu"))
    load_flax_variables(model, variables)
    return det, jax.tree_util.tree_map(jnp.asarray, variables), model


def images(seed):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, *HW, 3)).astype(np.uint8)


# -------------------------------------------------------- postprocess_probe
@pytest.mark.parametrize("h,w", [(12, 20), (6, 10), (3, 5)])
def test_level_candidates_match_jax(h, w):
    """Every slot valid at the two larger levels; at 3 x 5 (1,200 pairs, ~360
    above the threshold) the rest tie at rank 0, where the order of the
    slots is the top-k's own: compared where valid."""
    a = postprocess_probe.level_inputs(BATCH, h, w, seed=h)
    want = jax.jit(lambda *x: jax_level_candidates(
        *x, postprocess_probe.THRESH, postprocess_probe.K, approx=False))(*map(jnp.asarray, a))
    got = [t.numpy() for t in postprocess_probe.level_candidates(*map(torch.from_numpy, a))]
    boxes, scores, classes, valid, locs = (np.asarray(x) for x in want)
    assert valid.sum() > 0 and valid.all() == (h * w * postprocess_probe.C > 3000)
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[2][valid], classes[valid])
    np.testing.assert_array_equal(got[4][valid], locs[valid])
    np.testing.assert_allclose(got[0][valid], boxes[valid], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[1], scores, rtol=0, atol=SCORE_ATOL)


def test_nms_keep_sets_match_jax_on_integer_boxes():
    bx, sc, cl, vl = postprocess_probe.nms_inputs(BATCH, 5 * postprocess_probe.K, seed=3)
    bx = np.round(bx)
    want_idx, want_valid = jax.jit(jax.vmap(lambda b, s, c, v: jax_batched_nms(
        b, s, c, postprocess_probe.NMS_THRESH, postprocess_probe.MAX_DETS, valid=v)))(
        bx, sc, cl, vl)
    got_idx, got_valid = postprocess_probe.nms(*map(torch.from_numpy, (bx, sc, cl, vl)))
    want_valid = np.asarray(want_valid)
    assert want_valid.sum() > 0
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    np.testing.assert_array_equal(got_idx.numpy()[want_valid], np.asarray(want_idx)[want_valid])


# ---------------------------------------------------------- predict_profile
@pytest.fixture(scope="module")
def fcos():
    det, jvars, model = build_pair(predict_profile.CONFIG, R18, seed=5)
    batch = _profile.predict_batch(BATCH, HW, torch.device("cpu"))
    batch["image"] = torch.from_numpy(images(6))
    head = jax.jit(lambda v, x: det.module.apply(v, x, train=False))(
        jvars, jnp.asarray(batch["image"].numpy()))
    return det, model, batch, jax.tree_util.tree_map(np.array, head)


def test_predict_profile_fwd_matches_jax(fcos):
    _, model, batch, want = fcos
    with torch.inference_mode():
        got = predict_profile.stages(model, batch)["fwd"]()
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 5
        for g, w in zip(g_list, w_list):
            assert tuple(g.shape) == w.shape
            assert ratio(g.numpy(), w) <= FEATURE_TOL


def test_predict_profile_candidates_match_jax(fcos):
    """``fwd+cand``'s candidate half: the JAX script's per-level
    ``_fcos_level_candidates`` (exact top-k) concatenated, against
    ``FCOS.candidates`` on the same head outputs."""
    det, model, _, head = fcos
    logits_l, reg_l, ctr_l = head
    locations, counts = det._locations(HW)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    outs = [jax_level_candidates(
        jnp.asarray(logits_l[lvl]), jnp.asarray(reg_l[lvl]), jnp.asarray(ctr_l[lvl]),
        jnp.asarray(locations[offsets[lvl]:offsets[lvl + 1]]), det.pre_nms_thresh,
        det.pre_nms_top_n, approx=det.approx_topk) for lvl in range(len(counts))]
    want = [np.concatenate([np.asarray(o[i]) for o in outs], axis=1) for i in range(5)]
    got = model.candidates(*([torch.from_numpy(a) for a in lv] for lv in head), HW)
    assert want[3].sum() > 0
    for i in (2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=SCORE_ATOL)


# --------------------------------------------------------- profile_backbone
def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_profile_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flops_equal_the_jax_script():
    """``conv_flops`` is the JAX script's; the stage sums are its
    ``stage_flops`` (``tools/profile_backbone.py:114-120``, a closure in
    its ``main``, copied here) over R-50 at 800 x 1344."""
    jconv = jax_script("profile_backbone").conv_flops
    for args in [(100, 3, 64, 7), (5, 64, 256, 1), (7, 128, 128, 3), (1, 1, 1)]:
        assert _profile.conv_flops(*args) == jconv(*args)

    def jax_stage_flops(n, cin, mid, cout, ho, wo):
        f = jconv(ho * wo, cin, mid) + jconv(ho * wo, mid, mid, 3) \
            + jconv(ho * wo, mid, cout) + jconv(ho * wo, cin, cout)
        f += (n - 1) * (jconv(ho * wo, cout, mid) + jconv(ho * wo, mid, mid, 3)
                        + jconv(ho * wo, mid, cout))
        return f

    H, W = 800, 1344
    total = jconv((H // 2) * (W // 2), 3, 64, 7)
    assert profile_backbone.stem_flops(H, W) == total
    specs = [("res2", 3, 64, 64, 256, (H // 4, W // 4), 1),
             ("res3", 4, 256, 128, 512, (H // 4, W // 4), 2),
             ("res4", 6, 512, 256, 1024, (H // 8, W // 8), 2),
             ("res5", 3, 1024, 512, 2048, (H // 16, W // 16), 2)]
    assert profile_backbone.stage_specs(H, W) == specs
    port_total = profile_backbone.stem_flops(H, W)
    for _, n, cin, mid, cout, (h, w), s in specs:
        f = jax_stage_flops(n, cin, mid, cout, h // s, w // s)
        assert profile_backbone.stage_flops(n, cin, mid, cout, h // s, w // s) == f
        total += f
        port_total += f
    assert port_total == total


class JaxStem(fnn.Module):
    """The JAX script's ``Stem`` (``tools/profile_backbone.py:75-84``)."""

    @fnn.compact
    def __call__(self, x):
        x = (x - 110.0) / 57.0
        x = fnn.Conv(64, (7, 7), (2, 2), padding=3, use_bias=False, dtype=jnp.float32,
                     param_dtype=jnp.float32)(x)
        x = fnn.relu(x)
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))


class JaxStage(fnn.Module):
    """The JAX script's ``Stage`` (``tools/profile_backbone.py:94-108``)."""
    n: int
    bottleneck: int
    out_ch: int
    stride: int

    @fnn.compact
    def __call__(self, x):
        for i in range(self.n):
            x = JaxBottleneck(features=self.out_ch, bottleneck=self.bottleneck,
                              stride=self.stride if i == 0 else 1, norm="FrozenBN",
                              dtype=jnp.float32, name=f"b{i}")(x)
        return x


def frozen_bn_away_from_identity(tree, rs):
    return jax.tree_util.tree_map(
        lambda a: (rs.uniform(0.75, 1.25, a.shape) if a.ndim and np.all(a == 1)
                   else rs.randn(*a.shape) * 0.05).astype(np.float32), tree)


def test_stem_matches_jax():
    x = np.random.RandomState(7).randint(0, 256, (BATCH, *HW, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, JaxStem().init(jax.random.PRNGKey(1), x))
    want = jax.jit(JaxStem().apply)(variables, x)
    stem = profile_backbone.Stem()
    load_flax_variables(stem, variables)
    with torch.inference_mode():
        got = stem(torch.from_numpy(x))
    assert tuple(got.shape) == (BATCH, 64, HW[0] // 4, HW[1] // 4)
    assert ratio(nhwc(got), want) <= FEATURE_TOL


def test_stage_matches_jax():
    """res2 (3 blocks, a projection shortcut first) on a (2, 16, 16, 64)
    input, FrozenBN drawn away from identity."""
    name, n, cin, mid, cout, _, s = profile_backbone.stage_specs(*HW)[0]
    rs = np.random.RandomState(8)
    x = np.maximum(rs.randn(BATCH, 16, 16, cin), 0).astype(np.float32)
    jstage = JaxStage(n=n, bottleneck=mid, out_ch=cout, stride=s)
    variables = jax.tree_util.tree_map(np.asarray, jstage.init(jax.random.PRNGKey(2), x))
    variables = {"params": variables["params"],
                 "buffers": frozen_bn_away_from_identity(variables["buffers"], rs)}
    want = jax.jit(jstage.apply)(variables, x)
    stage = profile_backbone.Stage(name, n, cin, mid, cout, s, fused=False)
    load_flax_variables(stage, {c: {f"{name}_{k[1:]}": v for k, v in tree.items()}
                                for c, tree in variables.items()})
    with torch.inference_mode():
        got = stage(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ratio(nhwc(got), want) <= FEATURE_TOL


# ------------------------------------------------------------- rcnn_profile
@pytest.fixture(scope="module")
def rcnn():
    def small_deltas(variables):
        """The random trunk's features are in the hundreds: RPN deltas that
        small keep the proposals inside the image and wider than MIN_SIZE."""
        variables["params"]["rpn_head"]["anchor_deltas"]["kernel"] *= np.float32(1e-3)

    det, jvars, model = build_pair(rcnn_profile.CONFIG, RCNN_TINY, seed=9, edit=small_deltas)
    img = images(10)
    main_vars, roi_vars = det._split_variables(jvars)
    logits_l, deltas_l, roi_feats = jax.jit(det.module.apply)(main_vars, jnp.asarray(img))
    anchors, counts = det._rpn_anchors(HW)
    logits = jnp.concatenate(logits_l, axis=1)
    deltas = jnp.concatenate(deltas_l, axis=1)
    sizes = jnp.broadcast_to(jnp.asarray(HW, jnp.int32), (BATCH, 2))
    props = jax.jit(lambda lg, dl: det.rpn.proposals(anchors, counts, lg, dl, sizes,
                                                     train=False))(logits, deltas)

    def pool(fused):
        return jax.jit(jax.vmap(lambda *a: det.roi_heads.pool(list(a[:-1]), a[-1],
                                                              fused=fused)))(*roi_feats, props[0])

    pooled = {True: pool(True), False: pool(False)}
    head = jax.jit(det.roi_heads.module.apply)(roi_vars, pooled[True])
    as_np = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    return model, img, as_np((logits_l, deltas_l, roi_feats, logits, deltas, props, pooled,
                              head))


def test_rcnn_forward_matches_jax(rcnn):
    model, img, (logits_l, deltas_l, roi_feats, *_) = rcnn
    batch = {"image": torch.from_numpy(img), "scale": torch.ones(BATCH),
             "orig_size": torch.tensor([HW] * BATCH, dtype=torch.float32)}
    with torch.inference_mode():
        got = rcnn_profile.stages(model, batch)["backbone+RPN fwd"]()
    for g, w in zip(got[0] + got[1], logits_l + deltas_l):
        assert ratio(g.numpy(), w) <= FEATURE_TOL
    for g, w in zip(got[2], roi_feats):
        assert ratio(nhwc(g), w) <= FEATURE_TOL


def test_rcnn_proposals_match_jax(rcnn):
    model, _, (*_, logits, deltas, props, _, _) = rcnn
    anchors, counts = model.rpn_anchors(HW)
    with torch.inference_mode():
        boxes, scores, valid = model.rpn.proposals(
            anchors, counts, torch.from_numpy(logits), torch.from_numpy(deltas),
            torch.tensor(HW).expand(BATCH, 2), train=False)
    v = props[2]
    assert v.sum() > 0
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_allclose(boxes.numpy()[v], props[0][v], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(scores.numpy()[v], props[1][v], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "all_level"])
def test_rcnn_pooled_features_match_jax(rcnn, fused):
    model, _, (_, _, roi_feats, _, _, props, pooled, _) = rcnn
    with torch.inference_mode():
        got = model.roi_heads.pool([nchw(f) for f in roi_feats], torch.from_numpy(props[0]),
                                   fused=fused)
    assert tuple(got.shape) == pooled[fused].shape
    assert ratio(got.numpy(), pooled[fused]) <= POOL_TOL


def test_rcnn_box_head_matches_jax(rcnn):
    model, _, (*_, pooled, (scores, deltas)) = rcnn
    with torch.inference_mode():
        got_scores, got_deltas = model.roi_box(torch.from_numpy(pooled[True]))
    assert ratio(got_scores.numpy(), scores) <= POOL_TOL
    assert ratio(got_deltas.numpy(), deltas) <= POOL_TOL


# -------------------------------------------------------- reppoints_profile
def test_reppoints_backbone_matches_jax():
    det, jvars, model = build_pair(reppoints_profile.CONFIG, R18, seed=11)
    img = images(12)
    mod_vars = det._module_variables(jvars)
    bb_vars = {"params": mod_vars["params"]["backbone"],
               "buffers": mod_vars["buffers"]["backbone"]}
    mean = jnp.asarray(det.module.pixel_mean)
    std = jnp.asarray(det.module.pixel_std)

    def backbone_only(v, x):
        feats = det.module.backbone.apply(v, (x.astype(jnp.float32) - mean) / std)
        return [feats[f] for f in det.module.in_features]

    want = jax.jit(backbone_only)(bb_vars, jnp.asarray(img))
    with torch.inference_mode():
        got = model.features(torch.from_numpy(img))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert ratio(nhwc(g), np.asarray(w)) <= FEATURE_TOL


def test_deform_sample_batched_matches_jax():
    cat, off = reppoints_profile.gather_inputs(BATCH, 10, 12, 16, seed=13)
    want = jax.jit(jax_deform_sample)(cat, off)
    got = reppoints_profile.deform_sample_batched(torch.from_numpy(cat), torch.from_numpy(off))
    assert tuple(got.shape) == want.shape == (BATCH, 10, 12, 9, 16)
    assert ratio(got.numpy(), want) <= GATHER_TOL


# ----------------------------------------------------------- corner_profile
def jax_corner_decode(tl, br, upto, k=100, stride=4, max_dets=100):
    """The JAX script's decode closure (``tools/corner_profile.py:93-153``)
    on head outputs, from the package's ``batched_nms``."""
    def corners(heat, tag, off):
        B, H, W, C = heat.shape
        p = jax.nn.sigmoid(heat)
        pooled = fnn.max_pool(p, (3, 3), strides=(1, 1), padding="SAME")
        p = jnp.where(p == pooled, p, 0.0)
        scores, idx = jax.lax.top_k(p.reshape(B, H * W * C), k)
        cls = (idx % C).astype(jnp.int32)
        loc = idx // C
        iy = (loc // W).astype(jnp.float32)
        ix = (loc % W).astype(jnp.float32)
        t = jnp.take_along_axis(tag.reshape(B, H * W), loc, axis=1)
        o = jnp.take_along_axis(off.reshape(B, H * W, 2), loc[..., None], axis=1)
        return scores, cls, (ix + o[..., 0]) * stride, (iy + o[..., 1]) * stride, t

    ts, tc, tx, ty, ttag = corners(*tl)
    bs, bc, bx, by, btag = corners(*br)
    if upto == "topk":
        return ts, tc, tx, ty, ttag, bs, bc, bx, by, btag
    B = ts.shape[0]
    score = (ts[:, :, None] + bs[:, None, :]) / 2
    same = tc[:, :, None] == bc[:, None, :]
    geom = (bx[:, None, :] > tx[:, :, None]) & (by[:, None, :] > ty[:, :, None])
    tagd = jnp.abs(ttag[:, :, None] - btag[:, None, :]) < 0.5
    score = jnp.where(same & geom & tagd, score, 0.0)
    top, idx = jax.lax.top_k(score.reshape(B, k * k), min(max_dets * 4, k * k))
    ti, bi = idx // k, idx % k
    boxes = jnp.stack([jnp.take_along_axis(tx, ti, 1), jnp.take_along_axis(ty, ti, 1),
                       jnp.take_along_axis(bx, bi, 1), jnp.take_along_axis(by, bi, 1)], -1)
    classes = jnp.take_along_axis(tc, ti, 1)
    det_valid = top > 0.05
    if upto == "pair":
        return boxes, top, classes, det_valid

    def one(bx_, sc, cl, vl):
        keep_idx, keep_valid = jax_batched_nms(bx_, sc, cl, 0.5, max_dets, valid=vl)
        return bx_[keep_idx], sc[keep_idx], cl[keep_idx], keep_valid

    return jax.vmap(one)(boxes, top, classes, det_valid)


def corner_heads(seed, hw=(16, 16), classes=8):
    """Seeded (heat, tag, offset) maps of a TL and a BR head, float32 NHWC:
    heat logits ``randn * 2``, tags ``randn * 0.2`` (close enough that pairs
    form), offsets in [0, 1)."""
    rs = np.random.RandomState(seed)

    def side():
        return (rs.randn(BATCH, *hw, classes).astype(np.float32) * 2,
                rs.randn(BATCH, *hw).astype(np.float32) * 0.2,
                rs.rand(BATCH, *hw, 2).astype(np.float32))
    return side(), side()


@pytest.mark.parametrize("upto", corner_profile.DECODE_STAGES)
def test_corner_decode_matches_jax(upto):
    tl, br = corner_heads(14)
    want = [np.asarray(a) for a in jax.jit(lambda a, b: jax_corner_decode(a, b, upto))(tl, br)]
    got = [t.numpy() for t in corner_profile.corner_decode(
        [torch.from_numpy(a) for a in tl], [torch.from_numpy(a) for a in br], upto, 100)]
    assert len(got) == len(want)
    if upto == "topk":        # every corner a distinct positive peak: exact order
        assert (want[0] > 0).all() and (want[5] > 0).all()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    # slots past the last positive pair score tie at 0 and may order differently
    if upto == "pair":
        keep = want[1] > 0
        assert 0 < keep.sum() < keep.size
        np.testing.assert_array_equal(got[1] > 0, keep)
    else:
        keep = want[3]
        assert keep.sum() > 0
        np.testing.assert_array_equal(got[3], keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[keep], w[keep])


# --------------------------------------------------------------- the mains
FCOS_LABELS = ["fwd ", "fwd+cand ", "full "]
BACKBONE_LABELS = [f"B=1 {HW[0]}x{HW[1]} float32", "stage", "GFLOP/img", "TFLOPS",
                   "stem(norm+7x7+pool)", "res2", "res3", "res4", "res5", "full-resnet50",
                   "backbone+FPN(graph)", "fwd(backbone+head)", "predict(full)"]
TINY_LEVELS = [(12, 20), (6, 10)]
MAINS = [
    ("predict_profile", {"OVERRIDES": R18, "HW": HW}, ["--batch", "2", "--reps", "1"],
     FCOS_LABELS),
    ("postprocess_probe", {"LEVELS": TINY_LEVELS}, ["--batch", "2"],
     ["cand  12x 20 (L=   240)", "cand   6x 10 (L=    60)", "cand total",
      "nms  (B,5000)x100"]),
    ("profile_backbone", {"HW": HW, "DTYPE": torch.float32,
                          "OVERRIDES": ["TPU.COMPUTE_DTYPE", "float32"]},
     ["--batch", "1", "--reps", "1"], BACKBONE_LABELS),
    ("profile_backbone", {"HW": HW, "DTYPE": torch.float32,
                          "OVERRIDES": ["TPU.COMPUTE_DTYPE", "float32"]},
     ["--batch", "1", "--reps", "1", "--fused"], BACKBONE_LABELS),
    ("rcnn_profile", {"OVERRIDES": RCNN_TINY, "HW": HW},
     ["--batch", "2", "--reps", "1", "--all-level-pool"],
     ["B=2 64x64:", "backbone+RPN fwd", "+RPN proposals", "+ROIAlign pool", "+box head",
      "full predict", "ms/img final NMS", "total"]),
    ("reppoints_profile", {"OVERRIDES": R18, "HW": HW, "GATHER": (10, 12, 16)},
     ["--batch", "2", "--reps", "1", "--full"],
     ["B=2 64x64:", "backbone+FPN", "full head forward", "ms/img head", "full predict",
      "ms/img post", "P3 2C gather alone"]),
    ("corner_profile", {"OVERRIDES": CORNER_TINY},
     ["--batch", "2", "--reps", "1", "--size", "64", "64", "--stages"],
     ["decode stages (vs fwd", "NOTE", "+corner topk", "+pairing", "+NMS", "B=2 64x64:",
      "hourglass backbone", "+pools/heads", "full predict", "ms/img decode", "total"]),
]
FLAGS = ("--fused", "--all-level-pool", "--full", "--stages")
TOOLS = {"predict_profile": predict_profile, "postprocess_probe": postprocess_probe,
         "profile_backbone": profile_backbone, "rcnn_profile": rcnn_profile,
         "reppoints_profile": reppoints_profile, "corner_profile": corner_profile}


@pytest.mark.parametrize("name,hooks,argv,labels", MAINS,
                         ids=[" ".join([m[0], *(a for a in m[2] if a in FLAGS)])
                              for m in MAINS])
def test_main_prints_the_jax_labels_on_the_cpu(monkeypatch, name, hooks, argv, labels):
    tool = TOOLS[name]
    for k, v in hooks.items():
        monkeypatch.setattr(tool, k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tool.main(["--device", "cpu", *argv])
    text = out.getvalue()
    assert text.startswith("cpu, 1 torch threads\n")
    at = 0
    for label in labels:
        at = text.find(label, at)
        assert at >= 0, (label, text)
        at += len(label)
    assert res["ms"] and all(math.isfinite(v) and v > 0 for v in res["ms"].values())
    assert set(res["launches"]) <= set(res["ms"])
    assert all(v == {} for v in res["launches"].values())     # CPU: the plain versions


def test_cuda_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(SystemExit) as e:
        predict_profile.main(["--batch", "1"])
    assert e.value.code not in (0, None)
