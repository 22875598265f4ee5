"""The port's VT-FPN (``slenderobjdet_torch/models/backbones/vt_fpn.py``),
the four builders it registers and the bridge's rules for their leaves, held
against the JAX package on the CPU, in float32:

- ``Tokenizer``, ``TokenTransformer`` (Flax ``nn.SelfAttention``) and
  ``Projector`` at 64 channels: outputs (1e-5 of the largest value) and the
  gradients of a weighted sum with respect to their inputs (1e-4);
- ``VTFPN`` on R-18 with a 64-wide neck at 64 x 96: P3-P7 and the gradient
  with respect to the image;
- RetinaNet on ``build_retinanet_resnet_vt_fpn`` and
  ``build_retinanet_resnet_vt_fpn_backbone_use_p5`` (R-18, FrozenBN, the
  JAX package builds one network for both names) at 64 x 64: head outputs,
  losses, gradients, predict slot for slot, one ``TrainStep`` at two weight
  decays, ``param_labels`` leaf for leaf and the int8 sites (the harness of
  ``tests/test_torch_pvt.py``);
- ``build_model(cfg, device="cpu")`` on each of the four names at the yaml's
  widths, with the JAX ``BackboneSpec``'s strides; the bridge's
  ``pos_embed``, ``SelfAttention`` and ``dwconv`` rules, each on its leaf.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.backbones import fpn as tfpn  # noqa: E402
from slenderobjdet_torch.models.backbones import resnet as tresnet  # noqa: E402
from slenderobjdet_torch.models.backbones import vt_fpn as tvt  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.backbones import resnet as jresnet  # noqa: E402
from slenderobjdet_tpu.models.backbones import vt_fpn as jvt  # noqa: E402
from test_torch_pvt import (MODULE_GRAD_TOL, MODULE_TOL, PVT_FAMILIES, PVT_OVERRIDES,  # noqa: E402
                            WEIGHT_DECAYS, check_heads, check_int8_sites, check_labels,
                            check_loss_and_gradients, check_predict, check_train_step,
                            detector_case, detector_cfg, draw_tree, nchw,
                            one_torch_thread, ratio, weighted_sum)  # noqa: F401

VT_NAMES = ("build_retinanet_resnet_vt_fpn", "build_retinanet_resnet_vt_fpn_backbone_use_p5")
VT_OVERRIDES = {"MODEL.RESNETS.DEPTH": 18}
C = 64


# ------------------------------------------------------------ modules
def compare(jmod, tmod, args, torch_args, out_to_np, seed):
    """jmod(*args) against tmod(*torch_args(args)): the output, and the
    gradients of a weighted sum of it with respect to every input."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    variables = draw_tree(shapes, seed)
    tmod.load_state_dict(flax_to_state_dict(variables))
    weights = weighted_sum({"out": jax.eval_shape(jmod.apply, variables, *args)}, seed + 1)["out"]

    def objective(*a):
        out = jmod.apply(variables, *a)
        return jnp.sum(out * weights), out

    argnums = tuple(range(len(args)))
    (_, want), want_grads = jax.jit(jax.value_and_grad(objective, argnums, has_aux=True))(*args)
    inputs = [t.requires_grad_(True) for t in torch_args(args)]
    got = tmod(*inputs)
    assert ratio(out_to_np(got.detach()), want) <= MODULE_TOL
    torch.sum(torch.from_numpy(np.ascontiguousarray(nchw(weights) if got.dim() == 4 else weights))
              * got).backward()
    for t, g in zip(inputs, want_grads):
        got_g = t.grad.permute(0, 2, 3, 1) if t.dim() == 4 else t.grad
        assert ratio(got_g.numpy(), g) <= MODULE_GRAD_TOL


def feature(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def as_nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_tokenizer_matches_jax():
    x = feature(1, (2, 8, 12, C))
    compare(jvt.Tokenizer(16), tvt.Tokenizer(C, 16), (x,), lambda a: [as_nchw(a[0])],
            lambda t: t.numpy(), seed=2)


def test_token_transformer_matches_jax():
    tokens = feature(3, (2, 48, C))
    compare(jvt.TokenTransformer(), tvt.TokenTransformer(C), (tokens,),
            lambda a: [torch.from_numpy(a[0])], lambda t: t.numpy(), seed=4)


def test_projector_matches_jax():
    x, tokens = feature(5, (2, 8, 12, C)), feature(6, (2, 48, C))
    compare(jvt.Projector(), tvt.Projector(C), (x, tokens),
            lambda a: [as_nchw(a[0]), torch.from_numpy(a[1])],
            lambda t: t.permute(0, 2, 3, 1).numpy(), seed=7)


def r18_cfg(get_cfg):
    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.freeze()
    return cfg


def test_vt_fpn_on_r18_matches_jax():
    """P3-P7 of the VT-FPN over R-18 (FrozenBN away from identity) and the
    gradient of a weighted sum of them with respect to the image."""
    feats = ("res3", "res4", "res5")
    jmod = jvt.VTFPN(bottom_up=jresnet.resnet_from_cfg(r18_cfg(jax_get_cfg)), in_features=feats,
                     out_channels=C)
    tmod = tvt.VTFPN(tresnet.resnet_from_cfg(r18_cfg(torch_get_cfg)), feats, [128, 256, 512],
                     [8, 16, 32], out_channels=C)
    x = feature(8, (2, 64, 96, 3))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    variables = draw_tree(shapes, seed=9)
    tmod.load_state_dict(flax_to_state_dict(variables))
    weights = weighted_sum(jax.eval_shape(jmod.apply, variables, x), seed=10)

    def objective(a):
        out = jmod.apply(variables, a)
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), g_x = jax.jit(jax.value_and_grad(objective, has_aux=True))(x)
    xt = as_nchw(x).requires_grad_(True)
    got = tmod(xt)
    assert sorted(got) == sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    assert tmod.strides == {f"p{k}": 2 ** k for k in range(3, 8)}
    for k in want:
        assert ratio(got[k].detach().numpy(), nchw(want[k])) <= MODULE_TOL, k
    sum(torch.sum(got[k] * torch.from_numpy(nchw(w))) for k, w in weights.items()).backward()
    assert ratio(xt.grad.permute(0, 2, 3, 1).numpy(), g_x) <= MODULE_GRAD_TOL


# ------------------------------------------------------------ detectors
def test_the_two_vt_names_are_one_jax_network():
    specs = [jax_build_model(detector_cfg(jax_get_cfg, {**VT_OVERRIDES, "MODEL.BACKBONE.NAME": n}))
             .backbone_spec for n in VT_NAMES]
    assert specs[0].module == specs[1].module and specs[0].strides == specs[1].strides


@pytest.fixture(scope="module")
def reference():
    """Drawn at full deviation, the 1x1 scores of the tokenizers and the
    projectors' q . k over the random R-18's laterals (which no norm scales)
    spread so widely that their softmaxes are nearly one-hot and their
    gradients cancel: the port's own fp32 gradients were up to 4.8e-3
    (``tokenizer1.attn.weight``) and 14 x (``projector0.q.bias``) of their
    largest value away from its fp64 ones, and JAX's as far. With the
    tokenizers' and projectors' kernels at a tenth of their deviation the
    port's fp32 gradients lie within 5.6e-4 of fp64 (both measured on this
    draw)."""
    return detector_case({"MODEL.BACKBONE.NAME": VT_NAMES[1], **VT_OVERRIDES}, seed=40,
                         tenth=("tokenizer", "projector"))


@pytest.fixture(scope="module", params=VT_NAMES)
def case(request, reference):
    """The JAX reference of the one network, with the port's model built
    under each name and loaded with the same weights."""
    overrides = {"MODEL.BACKBONE.NAME": request.param, **VT_OVERRIDES}
    if request.param == reference["overrides"]["MODEL.BACKBONE.NAME"]:
        return reference
    model = torch_build_model(detector_cfg(torch_get_cfg, overrides), device="cpu")
    load_flax_variables(model, reference["variables"])
    return {**reference, "model": model, "overrides": overrides}


VT_CHECKED = ["backbone.lateral0.weight", "backbone.tokenizer2.attn.weight",
              "backbone.transformer.attn1.query.weight", "backbone.transformer.attn0.out.bias",
              "backbone.transformer.ln2_1.weight", "backbone.projector0.v.weight",
              "backbone.output1.weight", "backbone.top_p7.weight",
              "backbone.bottom_up.res4_0.conv1.weight", "head.bbox_pred.weight"]


def test_vt_retinanet_heads_match_jax(case):
    check_heads(case)


def test_vt_retinanet_loss_and_gradients_match_jax(case):
    # a key's bias adds q . b to all of a query's scores, a tokenizer's bias
    # one constant to all of a token's positions: the softmaxes cancel them
    check_loss_and_gradients(case, VT_CHECKED, invariant=r"(key|\.k|tokenizer\d\.attn)\.bias$")


def test_vt_retinanet_predict_matches_jax(case):
    check_predict(case)


@pytest.mark.parametrize("wd", WEIGHT_DECAYS)
def test_vt_retinanet_train_step_matches_jax(case, wd):
    check_train_step(case, wd)


def test_vt_param_labels_equal_jax_leaf_for_leaf(case):
    check_labels(case)


def test_vt_int8_sites_match_jax_site_by_site(reference):
    check_int8_sites(reference, ["tokenizer0/attn", "output2", "lateral1", "bottom_up/res5_1"])


# ------------------------------------------------------------ builders, bridge
ALL_FOUR = {
    "build_retinanet_pvt_fpn_backbone": {**PVT_FAMILIES["pvt"]},
    "build_retinanet_pvtv2_fpn_backbone": {**PVT_FAMILIES["pvtv2"]},
    **{n: {"MODEL.BACKBONE.NAME": n} for n in VT_NAMES},
}


@pytest.mark.parametrize("name", list(ALL_FOUR))
def test_each_name_builds_on_the_cpu_with_jax_strides(name):
    """The yaml's widths (PVT-Small, R-50) through ``build_model``; the FPN
    takes pvt2-pvt4 by ``FEATURE_STRIDES``."""
    overrides = dict(ALL_FOUR[name])
    if "pvt" in name:
        overrides["MODEL.FPN.IN_FEATURES"] = PVT_OVERRIDES["MODEL.FPN.IN_FEATURES"]
    assert name in tfpn.BACKBONES
    model = torch_build_model(detector_cfg(torch_get_cfg, overrides), device="cpu")
    spec = jax_build_model(detector_cfg(jax_get_cfg, overrides)).backbone_spec
    assert model.backbone.strides == spec.strides
    assert model.strides == [8, 16, 32, 64, 128]
    if "pvt" in name:
        assert model.backbone.bottom_up.depths == (3, 4, 6, 3)
        assert tfpn.FEATURE_STRIDES["pvt2"] == 8


def test_bridge_places_the_new_leaves():
    """``pos_embed{i}`` keeps its layout; a ``SelfAttention``'s (C, H, D)
    kernels and (H, D) biases flatten heads-outermost and its (H, D, C)
    output kernel becomes (C, H * D); a depthwise (3, 3, 1, C) kernel becomes
    (C, 1, 3, 3)."""
    rs = np.random.RandomState(11)
    pos, q, qb = rs.randn(1, 7, 7, 4), rs.randn(6, 2, 3), rs.randn(2, 3)
    out, dw = rs.randn(2, 3, 6), rs.randn(3, 3, 1, 5)
    tree = {"params": {"backbone": {
        "bottom_up": {"pos_embed1": pos, "stage1_block0": {"dwconv": {"kernel": dw}}},
        "transformer": {"attn0": {"query": {"kernel": q, "bias": qb}, "out": {"kernel": out}}}}}}
    sd = {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}
    assert sorted(sd) == ["backbone.bottom_up.pos_embed1",
                          "backbone.bottom_up.stage1_block0.dwconv.weight",
                          "backbone.transformer.attn0.out.weight",
                          "backbone.transformer.attn0.query.bias",
                          "backbone.transformer.attn0.query.weight"]
    np.testing.assert_array_equal(sd["backbone.bottom_up.pos_embed1"], pos.astype(np.float32))
    w = sd["backbone.transformer.attn0.query.weight"]
    assert w.shape == (6, 6)
    np.testing.assert_array_equal(w[1 * 3 + 2], q[:, 1, 2].astype(np.float32))   # head 1, dim 2
    np.testing.assert_array_equal(sd["backbone.transformer.attn0.query.bias"][1 * 3 + 2],
                                  np.float32(qb[1, 2]))
    o = sd["backbone.transformer.attn0.out.weight"]
    assert o.shape == (6, 6)
    np.testing.assert_array_equal(o[:, 1 * 3 + 2], out[1, 2].astype(np.float32))
    d = sd["backbone.bottom_up.stage1_block0.dwconv.weight"]
    assert d.shape == (5, 1, 3, 3)
    np.testing.assert_array_equal(d[4, 0], dw[:, :, 0, 4].astype(np.float32))
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": {"backbone": {"pos_embed_x": pos}}})
