"""The port's int8 predict (``slenderobjdet_torch/ops/quant.py``) held against
the JAX package's ``slenderobjdet_tpu/ops/quant.py`` on the CPU:

- one conv, the same input tensor on both sides: the int8 activations and
  weights, their scales and the s32 sums bit for bit, and the rescaled
  output, in the dynamic and the static mode;
- which convs are taken over, site by site, against JAX's interceptor on
  the flagship at full width (64 x 64 images), the fused flags off and on;
- the tiny FCOS and RetinaNet (R-18, ``tests/conftest.py``) under
  ``TPU.INT8_PREDICT``, dynamic and static, against JAX's; the calibrated
  scales against ``traced_calibration``'s;
- every key of ``configs/int8_scales/fcos_R_50_bench.json`` names a
  static-eligible site of the port's flagship.

The families under ``TPU.INT8_PREDICT`` and the 28 names are
``tests/test_torch_quant_families.py``.
"""

import os
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.checkpoint.bridge import load_flax_variables  # noqa: E402
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.layers import Conv2d  # noqa: E402
from slenderobjdet_torch.ops import quant as tq  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.ops import quant as jq  # noqa: E402
from test_torch_serving import draw_variables  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
BENCH_SCALES = CONFIGS / "int8_scales/fcos_R_50_bench.json"
# Whole models: each side's fp32 convs sum in their own order, so an
# activation that lies within that rounding of a half-step of its int8 scale
# rounds to the neighbouring step on one side only. One such step moves its
# conv's outputs by (activation scale x weight), ~1e-3 of their range here,
# and the GroupNorm towers after it carry and widen the change (measured:
# 1 of 32,768 activations at P3's first tower input, 4,016 by the fourth).
# The tolerances below hold those steps; the conv itself is bit-exact
# (test_int8_conv_matches_jax_bit_for_bit).
INT8_HEAD_TOL = 0.08     # head outputs: max |diff| / max |value|, all levels
INT8_SCORE_TOL = 1e-2    # each image's detection scores, sorted
CALIB_RTOL = 1e-5        # the recorded amax: fp32 sums of different order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg, arch="FCOS", config=None, **overrides):
    """``tests/conftest.py``'s tiny FCOS (R-18, res3-res5, P6/P7 from P5,
    fp32) with exact top-k, on ``config``'s family."""
    cfg = get_cfg()
    if config is not None:
        cfg.merge_from_file(str(config))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone_use_p5"
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def predict_batch(seed=1, batch=2, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8][:batch], np.float32),
            "orig_size": np.array([hw, [51, 51]][:batch], np.float32)}


# ------------------------------------------------------------- one conv
@pytest.mark.parametrize("stride,cin,cout,k,groups", [
    (1, 256, 128, 3, 1), (2, 256, 256, 3, 1), (1, 128, 128, 1, 1), (1, 256, 256, 3, 2)])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_conv_matches_jax_bit_for_bit(stride, cin, cout, k, groups, mode):
    rs = np.random.RandomState(stride * 7 + k + groups)
    x = (rs.randn(2, 12, 12, cin) * 3).astype(np.float32)
    kernel = (rs.randn(k, k, cin // groups, cout) * 0.05).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    amax = None if mode == "dynamic" else float(np.abs(x).max() * 0.8)   # some clip

    wq, ws = jq.quantize_conv_kernel(jnp.asarray(kernel))
    if amax is None:
        xq, xs = jq.dynamic_quantize(jnp.asarray(x))
    else:
        xs = jnp.float32(max(amax, 1e-12) / 127.0)
        xq = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8)
    acc = lax.conv_general_dilated(xq, wq, (stride, stride), ((k // 2, k // 2),) * 2,
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   feature_group_count=groups,
                                   preferred_element_type=jnp.int32)
    conv = nn.Conv(cout, (k, k), (stride, stride), padding=k // 2, feature_group_count=groups)

    def take_over(next_fn, args, kwargs, context):     # whatever the eligibility
        return jq.int8_conv_call(context.module, args[0], act_scale=amax)

    with nn.intercept_methods(take_over):
        want = np.asarray(conv.apply(
            {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
            jnp.asarray(x)))

    tc = Conv2d(cin, cout, k, stride, k // 2, groups=groups)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        tc.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        twq, tws = tq.quantize_conv_kernel(tc.weight)
        if amax is None:
            txq, txs = tq.dynamic_quantize(xt)
        else:
            txs = torch.tensor(max(amax, 1e-12) / 127.0, dtype=torch.float32)
            txq = torch.clamp(torch.round(xt / txs), -127, 127).to(torch.int8)
        got_acc = tq.int8_sums(tc, txq, twq)
        got = tq.int8_conv_call(tc, xt, act_scale=amax).permute(0, 2, 3, 1).numpy()

    assert np.array_equal(np.asarray(wq), twq.numpy().transpose(2, 3, 1, 0))
    assert np.array_equal(np.asarray(ws), tws.numpy())
    assert np.array_equal(np.asarray(xq), txq.permute(0, 2, 3, 1).numpy())
    assert np.float32(xs) == txs.numpy()
    assert np.array_equal(np.asarray(acc), got_acc.numpy())
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ eligibility
def flagship_cfg(get_cfg, fused):
    return tiny_cfg(get_cfg, config=CONFIGS / "fcos/fcos_R_50_FPN_1x.yaml",
                    **{"MODEL.RESNETS.DEPTH": 50, "MODEL.RESNETS.OUT_FEATURES": ["res3", "res4", "res5"],
                       "MODEL.BACKBONE.NAME": "build_retinanet_resnet_fpn_backbone_use_p5",
                       "MODEL.RESNETS.FUSED_STEM": fused, "MODEL.RESNETS.FUSED_BLOCKS": fused})


def jax_sites(fused):
    """Every nn.Conv call of JAX's flagship forward (traced abstractly,
    nothing computed): (path, eligible, static_eligible)."""
    det = jax_build_model(flagship_cfg(jax_get_cfg, fused))
    sites = []

    def record(next_fn, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and type(mod) is nn.Conv:
            x = args[0]
            sites.append((jq.module_path(mod), jq.eligible(mod, x), jq.static_eligible(mod, x)))
        return next_fn(*args, **kwargs)

    def forward(key, images):
        variables = det.init_variables(key, (64, 64), batch_size=1)
        with nn.intercept_methods(record):
            return det.module.apply(variables, images, train=False)

    jax.eval_shape(forward, jax.random.PRNGKey(0),
                   jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.uint8))
    return sorted(sites)


def port_sites(model, images):
    sites = []

    def record(mod, x):
        sites.append((tq.module_path(mod), tq.eligible(mod, x), tq.static_eligible(mod, x)))
        return None

    with torch.no_grad(), tq._intercepting(record):
        model(images)
    return sorted(sites)


@pytest.fixture(scope="module")
def flagships():
    images = torch.from_numpy(predict_batch(batch=1)["image"])
    return {fused: (torch_build_model(flagship_cfg(torch_get_cfg, fused), device="cpu"), images)
            for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True], ids=["flags_off", "flags_on"])
def test_eligibility_matches_jax_site_by_site(flagships, fused):
    got = port_sites(*flagships[fused])
    want = jax_sites(fused)
    assert got == want
    eligible = {s for s, e, _ in got if e}
    static = {s for s, _, e in got if e}
    assert eligible and static > eligible
    blocks = {s.rsplit("/", 1)[0] for s in static if "/res" in s}
    # with the fused flags on only the stride-2 first block of res3-res5
    # (not fused) keeps its convs, and the stem is no conv call
    assert ("backbone/bottom_up/res4_1" in blocks) != fused
    assert any("stem" in s for s, _, _ in got) != fused


def test_bench_scales_name_sites_of_the_flagship(flagships):
    scales = tq.load_json_scales(str(BENCH_SCALES))
    assert len(scales) == 58
    static = {s for s, _, e in port_sites(*flagships[False]) if e}
    assert set(scales) <= static
    model = flagships[False][0]
    named = {m.site for m in model.modules() if isinstance(m, torch.nn.Conv2d)}
    assert set(scales) <= named


# ------------------------------------------------- tiny models against JAX
def _pair(arch, config, head):
    jcfg = tiny_cfg(jax_get_cfg, arch, config, **{"TPU.INT8_PREDICT": True})
    det = jax_build_model(jcfg)
    variables = draw_variables(det)
    variables["params"]["head"][head]["bias"][:] = 0.0     # detections from random weights
    model = torch_build_model(tiny_cfg(torch_get_cfg, arch, config,
                                       **{"TPU.INT8_PREDICT": True}), device="cpu")
    load_flax_variables(model, variables)
    return det, jax.tree_util.tree_map(jnp.asarray, variables), model


@pytest.fixture(scope="module")
def fcos_pair():
    return _pair("FCOS", None, "cls_logits")


@pytest.fixture(scope="module")
def jax_int8_outputs(fcos_pair):
    """The port's calibrated scales (full precision, ``traced_calibration``);
    then for each arch, from one compiled program (the scales are read as the
    program is traced): JAX's head outputs and detections under
    INT8_PREDICT, dynamic and static with the port's scales, and for FCOS
    JAX's own ``traced_calibration``."""
    retina = _pair("RetinaNet", CONFIGS / "retina/retinanet_R_50_FPN_1x.yaml", "cls_score")
    batch = predict_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = fcos_pair[2]
    model.int8_predict = False
    try:
        _, tam = tq.traced_calibration(model.predict)(batch)
    finally:
        model.int8_predict = True
    modes = {"dynamic": None, "static": {k: float(v) for k, v in tam.items()}}
    out = {}
    for arch, (det, jv, model) in (("FCOS", fcos_pair), ("RetinaNet", retina)):
        def fwd(v, image, det=det, arch=arch):
            return (det.module.apply(v, image, train=False) if arch == "FCOS"
                    else det.module.apply(v, image))

        def both(v, b, det=det, arch=arch, fwd=fwd):
            res = {}
            for mode, scales in modes.items():
                with jq.static_scales_scope(scales):
                    with jq.int8_predict_scope(True):
                        heads = fwd(v, b["image"])
                    res[mode] = (heads, det.predict(v, b))
            if arch == "FCOS":
                res["calibration"] = jq.traced_calibration(fwd)(v, b["image"])[1]
            return res
        out[arch] = (jax.jit(both)(jv, jbatch), model)
    return batch, modes, out


def test_calibration_scales_equal_jax(jax_int8_outputs):
    _, modes, out = jax_int8_outputs
    jam = {k: float(v) for k, v in out["FCOS"][0]["calibration"].items()}
    tam = modes["static"]
    assert sorted(jam) == sorted(tam) and len(tam) > 20
    for k in jam:
        assert tam[k] == pytest.approx(jam[k], rel=CALIB_RTOL), k


@pytest.mark.parametrize("arch", ["FCOS", "RetinaNet"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_tiny_predict_under_int8_matches_jax(jax_int8_outputs, arch, mode):
    batch, modes, outputs = jax_int8_outputs
    (want_heads, want), model = outputs[arch][0][mode], outputs[arch][1]
    scales = modes[mode]
    with torch.no_grad(), tq.int8_predict_scope(True), tq.static_scales_scope(scales):
        got_heads = model(torch.from_numpy(batch["image"]))
    with tq.static_scales_scope(scales):
        got = model.predict(batch)
    for w_l, g_l in zip(want_heads, got_heads):
        if w_l is None:
            continue
        span = max(float(np.abs(np.asarray(w)).max()) for w in w_l)
        err = max(float(np.abs(g.numpy() - np.asarray(w, np.float64)).max())
                  for w, g in zip(w_l, g_l))
        assert err <= INT8_HEAD_TOL * span, (err, span)
    assert np.array_equal(np.asarray(want["valid"]).sum(1), got["valid"].numpy().sum(1))
    assert got["valid"].sum() > 0
    np.testing.assert_allclose(np.sort(got["scores"].numpy(), 1),
                               np.sort(np.asarray(want["scores"]), 1), atol=INT8_SCORE_TOL)
    # the int8 path ran: the fp model's outputs differ
    model.int8_predict = False
    try:
        fp = model.predict(batch)
    finally:
        model.int8_predict = True
    assert not torch.equal(fp["scores"], got["scores"])
