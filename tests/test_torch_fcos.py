"""The PyTorch port's FCOS R-50-FPN predict path held against the JAX package
on the CPU, at narrow widths (R-50 structure; width 8 per group, res2 32,
stem 16, FPN 32), 64x64 images, batch 2, float32, exact top-k.

Both sides get the same weights: the JAX package's initialisation with
FrozenBN buffers drawn from a numpy seed (scale in [0.75, 1.25], small bias,
so the fused paths' folding is exercised) and the cls_logits bias at 0 (the
focal prior would keep every score under INFERENCE_TH), carried to the port
by ``checkpoint/bridge.py``.
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
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.ops import _build
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.models import build_model as jax_build_model
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

CONFIG = Path(__file__).resolve().parents[1] / "configs/fcos/fcos_R_50_FPN_1x.yaml"
FEATURE_TOL = 1e-4   # max |diff| / max |ref|: fp32, different conv sum orders


def narrow_cfg(get_cfg, fused=False):
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    r = cfg.MODEL.RESNETS
    r.WIDTH_PER_GROUP = 8
    r.RES2_OUT_CHANNELS = 32
    r.STEM_OUT_CHANNELS = 16
    r.FUSED_STEM = fused
    r.FUSED_BLOCKS = fused
    cfg.MODEL.FPN.OUT_CHANNELS = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.freeze()
    return cfg


def _randomize(variables, seed=0):
    """numpy copy of the Flax tree with random FrozenBN buffers and a zero
    cls_logits bias."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if set(v) == {"scale", "bias"}:
                    v["scale"] = rs.uniform(0.75, 1.25, v["scale"].shape).astype(np.float32)
                    v["bias"] = (rs.randn(*v["bias"].shape) * 0.05).astype(np.float32)
                else:
                    walk(v)
    walk(out["buffers"])
    out["params"]["head"]["cls_logits"]["bias"][:] = 0.0
    return out


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)


@pytest.fixture(scope="module")
def pair():
    jcfg = narrow_cfg(jax_get_cfg)
    det = jax_build_model(jcfg)
    variables = _randomize(det.init_variables(jax.random.PRNGKey(0)))
    model = torch_build_model(narrow_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, variables)
    rs = np.random.RandomState(1)
    batch = {
        "image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "scale": np.array([1.0, 0.8], np.float32),
        "orig_size": np.array([[64, 64], [51, 51]], np.float32),
    }
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return det, jvars, variables, model, batch


@pytest.fixture(scope="module")
def jax_outputs(pair):
    det, jvars, _, _, batch = pair
    head = det.module.apply(jvars, jnp.asarray(batch["image"]), train=False)
    dets = jax.jit(det.predict)(jvars, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree_util.tree_map(np.asarray, head),
            {k: np.asarray(v) for k, v in dets.items()})


def test_bridge_fills_every_tensor(pair):
    _, _, variables, model, _ = pair
    leaves = jax.tree_util.tree_leaves(variables)
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(leaves) == len(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(int(np.size(a)) for a in leaves)
    bad = {"params": {"head": {"mystery": {"kernel": np.zeros((3, 3, 2, 2))}}}}
    with pytest.raises(KeyError):
        load_flax_variables(model, {**variables, **bad})


def test_backbone_features_match(pair):
    det, jvars, _, model, batch = pair
    x = (batch["image"].astype(np.float32) - np.asarray(det.cfg.MODEL.PIXEL_MEAN,
                                                        np.float32))
    x = x / np.asarray(det.cfg.MODEL.PIXEL_STD, np.float32)
    bb = {c: jvars[c]["backbone"] for c in ("params", "buffers")}
    want = det.backbone_spec.module.apply(bb, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    for k in want:
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[k].shape
        assert _err(g, want[k]) <= FEATURE_TOL, k


def test_head_outputs_match(pair, jax_outputs):
    _, _, _, model, batch = pair
    want, _ = jax_outputs
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"]))
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 5
        for g, w in zip(g_list, w_list):
            assert tuple(g.shape) == w.shape
            assert _err(g.numpy(), w) <= FEATURE_TOL


def test_postprocess_matches_jax_exactly(pair, jax_outputs):
    """Fed the JAX head outputs, the port's candidates and NMS reproduce the
    JAX detections slot for slot."""
    _, _, _, model, batch = pair
    head, want = jax_outputs
    t = [[torch.tensor(np.asarray(a)) for a in lvl] for lvl in head]
    got = model.postprocess(*t, (64, 64), torch.from_numpy(batch["scale"]),
                            torch.from_numpy(batch["orig_size"]))
    valid = want["valid"]
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid],
                               rtol=0, atol=1e-5)


def _as_set(d, b):
    v = np.asarray(d["valid"][b])
    return {(int(c), tuple(np.round(np.asarray(x, np.float64), 3)))
            for c, x in zip(np.asarray(d["classes"][b])[v], np.asarray(d["boxes"][b])[v])}


def test_predict_matches_jax_as_sets(pair, jax_outputs):
    _, _, _, model, batch = pair
    _, want = jax_outputs
    got = {k: v.numpy() for k, v in model.predict(batch).items()}
    assert got["boxes"].shape == (2, 100, 4)
    assert got["scores"].shape == got["classes"].shape == got["valid"].shape == (2, 100)
    assert got["classes"].dtype == np.int32 and got["valid"].dtype == np.bool_
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 0
    for b in range(2):
        assert _as_set(got, b) == _as_set(want, b)
        v = want["valid"][b]
        np.testing.assert_allclose(np.sort(got["scores"][b][v]),
                                   np.sort(want["scores"][b][v]), rtol=0, atol=1e-5)


def test_fused_flags_on_cpu_take_the_plain_versions(pair):
    """FUSED_STEM and FUSED_BLOCKS on: on the CPU the seams run the kernels'
    plain versions (folded weights), launch nothing, and give the unfused
    detections."""
    _, _, variables, model, batch = pair
    fused = torch_build_model(narrow_cfg(torch_get_cfg, fused=True), device="cpu")
    load_flax_variables(fused, variables)
    _build.reset_launch_counts()
    got = {k: v.numpy() for k, v in fused.predict(batch).items()}
    assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)
    want = {k: v.numpy() for k, v in model.predict(batch).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for b in range(2):
        assert _as_set(got, b) == _as_set(want, b)
    with torch.no_grad():
        x = torch.from_numpy(batch["image"])
        for g, w in zip(fused(x)[0], model(x)[0]):
            assert _err(g.numpy(), w.numpy()) <= FEATURE_TOL


@pytest.mark.parametrize("name,fpn_norm,fuse", [
    ("build_resnet_fpn_backbone", "", "sum"),                     # P6 = P5[::2]
    ("build_retinanet_resnet_fpn_backbone", "", "sum"),           # P6/P7 from res5
    ("build_retinanet_resnet_fpn_backbone_use_p5", "GN", "avg"),  # P6/P7 from P5
    ("build_resnet_backbone", "", "sum"),                         # the trunk alone
])
def test_r18_backbones_match_jax(name, fpn_norm, fuse):
    """Basic blocks (R-18), every FPN top block, FPN norm and average
    fusion, fp32, random FrozenBN."""
    from slenderobjdet_torch.models.backbones.fpn import build_backbone as t_build
    from slenderobjdet_tpu.models.backbones.fpn import build_backbone as j_build

    cfgs = []
    for get_cfg in (jax_get_cfg, torch_get_cfg):
        cfg = get_cfg()
        cfg.merge_from_file(str(CONFIG))
        cfg.MODEL.RESNETS.DEPTH = 18
        cfg.MODEL.BACKBONE.NAME = name
        cfg.MODEL.FPN.NORM = fpn_norm
        cfg.MODEL.FPN.FUSE_TYPE = fuse
        cfgs.append(cfg)
    rs = np.random.RandomState(11)
    x = rs.randn(2, 64, 96, 3).astype(np.float32)
    module = j_build(cfgs[0], dtype=jnp.float32).module
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        module.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    for node in jax.tree_util.tree_leaves(
            variables["buffers"], is_leaf=lambda v: isinstance(v, dict) and "scale" in v):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    want = module.apply(variables, jnp.asarray(x))
    port = t_build(cfgs[1])
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[k].shape
        assert _err(g, want[k]) <= FEATURE_TOL, k


def test_head_variants_match_jax():
    """FCOSHead with NORM_REG_TARGETS (relu, times the stride at inference)
    and CENTERNESS_ON_REG, which the flagship config leaves off."""
    from slenderobjdet_torch.models.meta_arch.fcos import FCOSHead as THead
    from slenderobjdet_tpu.models.meta_arch.fcos import FCOSHead as JHead

    rs = np.random.RandomState(12)
    feats = [rs.randn(2, s, s + 2, 32).astype(np.float32) for s in (8, 4, 2)]
    kw = dict(num_classes=5, norm_reg_targets=True, centerness_on_reg=True,
              strides=(8, 16, 32))
    head = JHead(**kw)
    params = head.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats])
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    for lvl in range(3):   # scales away from 1 so each level's Scale matters
        params["params"][f"scale{lvl}"]["scale"] = np.float32(0.5 + lvl)
    want = head.apply(params, [jnp.asarray(f) for f in feats], train=False)
    port = THead(32, num_levels=3, **kw)
    load_flax_variables(port, params)
    with torch.no_grad():
        got = port([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert tuple(g.shape) == w.shape
            assert _err(g.numpy(), w) <= FEATURE_TOL
