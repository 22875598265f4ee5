"""The PyTorch port's deformable convolution held against the JAX package on
the CPU, in float32 at small shapes: ``kernel_base_offsets``,
``deform_conv2d_batched``, ``deform_sample_batched`` and ``deform_apply``
forward within 1e-5 and their feature, offset, weight and mask gradients
against ``jax.grad`` through the JAX custom VJP within 1e-4 (max |diff| over
max |JAX gradient|); ``DFConv2d`` v1 and v2 with bridged weights and a
randomised ``offset_conv``; zero offsets against ``F.conv2d``; the chunked
gather against itself unchunked; and the DCN options' forward against the
JAX package's within 1e-4 (max |diff| over max |JAX output| a level), with
every ``offset_conv`` randomised: ``DeformableConvRetinaNet``'s subnets,
FCOS's ``USE_DCN_IN_TOWER`` (v1 and v2) and the FPN levels of a narrow R-50
with ``DEFORM_ON_PER_STAGE`` (v1 and v2).

Offsets span inside, boundary and fully outside samples: half of them are
spread by 8 pixels on maps of 5-9 pixels, as the JAX package's own test
spreads them. Every input comes
from a numpy seed inside its test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slenderobjdet_torch.checkpoint.bridge import flax_to_state_dict, load_flax_variables
from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.models.layers import DeformConvLayer, DFConv2d
from slenderobjdet_torch.ops import deform_conv as tdc
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.models import build_model as jax_build_model
from slenderobjdet_tpu.models.layers import DFConv2d as JDFConv2d
from slenderobjdet_tpu.ops import deform_conv as jdc
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

ROOT = Path(__file__).resolve().parents[1]

FWD_TOL = 1e-5    # forward, max abs difference
GRAD_TOL = 1e-4   # gradients, max |diff| / max |JAX gradient|
MODEL_TOL = 1e-4  # whole-model outputs, max |diff| / max |JAX output| a level


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def case(seed, b=2, h=5, w=7, cin=6, cout=4, spread=8.0, integer=False):
    """x (B, H, W, Cin), absolute offsets (B, H, W, 9, 2) around the kernel
    grid, half of them jittered by 0.7 pixels and half by ``spread``, weight
    (9, Cin, Cout), bias, mask (B, H, W, 9), output cotangent."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, cin).astype(np.float32)
    jitter = rs.randn(b, h, w, 9, 2) * np.where(rs.rand(b, h, w, 9, 1) < 0.5, 0.7, spread)
    if integer:
        jitter = np.round(jitter)
    off = (jdc.kernel_base_offsets(3)[None, None, None] + jitter).astype(np.float32)
    weight = (rs.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    mask = rs.rand(b, h, w, 9).astype(np.float32)
    g = rs.randn(b, h, w, cout).astype(np.float32)
    return x, off, weight, bias, mask, g


def test_kernel_base_offsets_equal_jax():
    for k in (1, 3, 5):
        np.testing.assert_array_equal(tdc.kernel_base_offsets(k), jdc.kernel_base_offsets(k))
    assert tdc.kernel_base_offsets(3)[0].tolist() == [-1.0, -1.0]


def test_offsets_reach_inside_boundary_and_outside():
    """The cases below hold all three kinds of sample."""
    x, off, *_ = case(0)
    ys = np.arange(5)[None, :, None, None] + off[..., 0]
    xs = np.arange(7)[None, None, :, None] + off[..., 1]
    inside = (ys >= 0) & (ys <= 4) & (xs >= 0) & (xs <= 6)
    outside = (ys <= -1) | (ys >= 5) | (xs <= -1) | (xs >= 7)
    assert inside.mean() > 0.3 and outside.mean() > 0.3
    assert (~inside & ~outside).mean() > 0.05        # some taps in, some out


@pytest.mark.parametrize("with_mask,with_bias", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("integer", [False, True])
def test_deform_conv2d_batched_matches_jax(with_mask, with_bias, integer):
    """Forward and the four gradients. At integer positions (``integer``)
    the JAX custom VJP gives the forward difference; the port's backward is
    the same finite derivative, not autograd through ``floor``."""
    x, off, weight, bias, mask, g = case(1 + integer, integer=integer)
    jb = jnp.asarray(bias) if with_bias else None

    def jf(x, off, weight, mask):
        return jdc.deform_conv2d_batched(x, off, weight, jb, mask if with_mask else None)

    args = [jnp.asarray(a) for a in (x, off, weight, mask)]
    want = jf(*args)
    want_grads = jax.grad(lambda *a: jnp.sum(jf(*a) * g), argnums=(0, 1, 2, 3))(*args)

    tx, toff, tw, tm = [torch.tensor(a, requires_grad=True) for a in (x, off, weight, mask)]
    got = tdc.deform_conv2d_batched(tx, toff, tw, torch.tensor(bias) if with_bias else None,
                                    tm if with_mask else None, row_chunk=37)
    assert got.shape == want.shape == (2, 5, 7, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    for name, t, wg in zip(("feat", "offsets", "weight", "mask"), (tx, toff, tw, tm), want_grads):
        if name == "mask" and not with_mask:
            assert t.grad is None
            continue
        assert float(np.abs(np.asarray(wg)).max()) > 0, name
        assert ratio(t.grad.numpy(), wg) <= GRAD_TOL, name


def test_deform_sample_batched_matches_jax():
    x, off, *_ = case(3, cin=10)
    rs = np.random.RandomState(4)
    g = rs.randn(2, 5, 7, 9, 10).astype(np.float32)
    args = [jnp.asarray(x), jnp.asarray(off)]
    want = jdc.deform_sample_batched(*args)
    want_grads = jax.grad(lambda a, o: jnp.sum(jdc.deform_sample_batched(a, o) * g),
                          argnums=(0, 1))(*args)
    tx, toff = torch.tensor(x, requires_grad=True), torch.tensor(off, requires_grad=True)
    got = tdc.deform_sample_batched(tx, toff)
    assert got.shape == want.shape == (2, 5, 7, 9, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    assert ratio(tx.grad.numpy(), want_grads[0]) <= GRAD_TOL
    assert ratio(toff.grad.numpy(), want_grads[1]) <= GRAD_TOL


@pytest.mark.parametrize("with_bias", [True, False])
def test_deform_apply_matches_jax(with_bias):
    rs = np.random.RandomState(5)
    samples = rs.randn(2, 3, 4, 9, 6).astype(np.float32)
    weight = rs.randn(9, 6, 5).astype(np.float32)
    bias = rs.randn(5).astype(np.float32) if with_bias else None
    want = jdc.deform_apply(jnp.asarray(samples), jnp.asarray(weight),
                            None if bias is None else jnp.asarray(bias))
    got = tdc.deform_apply(torch.from_numpy(samples), torch.from_numpy(weight),
                           None if bias is None else torch.from_numpy(bias))
    assert got.shape == want.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=FWD_TOL)


def test_zero_offsets_equal_a_3x3_conv():
    """With the kernel grid as offsets the deformable conv is ``F.conv2d``
    with padding 1, its weight (K, Cin, Cout) read as (Cout, Cin, 3, 3)."""
    x, _, weight, bias, *_ = case(6, h=8, w=9)
    base = np.broadcast_to(tdc.kernel_base_offsets(3), (2, 8, 9, 9, 2)).copy()
    got = tdc.deform_conv2d_batched(torch.from_numpy(x), torch.from_numpy(base),
                                    torch.from_numpy(weight), torch.from_numpy(bias))
    w_oihw = torch.from_numpy(weight).permute(2, 1, 0).reshape(4, 6, 3, 3)
    want = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w_oihw, torch.from_numpy(bias),
                    padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FWD_TOL)


def test_chunks_change_no_result():
    """Any row chunk gives the same forward and offset gradient, bit for bit;
    the feature gradient's float32 sums add the taps in another order."""
    x, off, weight, bias, mask, g = case(7)
    outs = []
    for chunk in (1 << 20, 64, 5):
        tx, toff = torch.tensor(x, requires_grad=True), torch.tensor(off, requires_grad=True)
        y = tdc.deform_conv2d_batched(tx, toff, torch.from_numpy(weight),
                                      torch.from_numpy(bias), torch.from_numpy(mask),
                                      row_chunk=chunk)
        (y * torch.from_numpy(g)).sum().backward()
        outs.append((y.detach(), tx.grad, toff.grad))
    for y, gx, goff in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(goff, outs[0][2])
        assert ratio(gx.numpy(), outs[0][1].numpy()) <= 1e-6


def test_samples_fully_outside_are_zero_and_get_no_gradient():
    x, *_ = case(8)
    off = np.full((2, 5, 7, 9, 2), 50.0, np.float32)
    tx = torch.tensor(x, requires_grad=True)
    toff = torch.tensor(off, requires_grad=True)
    y = tdc.deform_sample_batched(tx, toff)
    assert float(y.abs().max()) == 0.0
    y.sum().backward()
    assert float(tx.grad.abs().max()) == 0.0 and float(toff.grad.abs().max()) == 0.0


def test_gradients_skip_what_is_not_needed():
    """A frozen feature map gets no gradient, and the offsets still do."""
    x, off, *_ = case(9)
    toff = torch.tensor(off, requires_grad=True)
    tdc.deform_sample_batched(torch.from_numpy(x), toff).sum().backward()
    assert toff.grad is not None and float(toff.grad.abs().max()) > 0


# ---------------------------------------------------------------- DFConv2d
def _jax_dfconv(modulated, cin, cout, seed, x):
    """JAX ``DFConv2d`` variables with ``offset_conv`` drawn so that samples
    are fractional and some fall outside (its init is zero)."""
    mod = JDFConv2d(cout, modulated=modulated)
    variables = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rs = np.random.RandomState(seed)
    params["offset_conv"]["kernel"] = (rs.randn(*params["offset_conv"]["kernel"].shape)
                                       * 0.6).astype(np.float32)
    params["offset_conv"]["bias"] = (rs.randn(*params["offset_conv"]["bias"].shape)
                                     * 0.5).astype(np.float32)
    params["bias"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return mod, {"params": params}


@pytest.mark.parametrize("modulated", [False, True])
def test_dfconv2d_matches_jax(modulated):
    """``DFConv2d`` v1 (18 offsets) and v2 (27: offsets and a sigmoid mask)
    with bridged weights: the output and the gradients of the input, the
    offset conv, the weight and the bias."""
    rs = np.random.RandomState(10 + modulated)
    x = rs.randn(2, 6, 8, 5).astype(np.float32)
    mod, variables = _jax_dfconv(modulated, 5, 7, 11, x)
    g = rs.randn(2, 6, 8, 7).astype(np.float32)

    def loss(params, x):
        return jnp.sum(mod.apply({"params": params}, x) * g)

    want = mod.apply(variables, jnp.asarray(x))
    want_params, want_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))
    want_grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_params)})

    layer = DFConv2d(5, 7, modulated=modulated)
    assert layer.offset_conv.out_channels == (27 if modulated else 18)
    layer.load_state_dict(flax_to_state_dict(variables))
    tx = torch.tensor(x, requires_grad=True)
    got = layer(tx.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert got.shape == (2, 7, 6, 8)
    got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    assert ratio(tx.grad.numpy(), want_x) <= GRAD_TOL
    for name, p in layer.named_parameters():
        assert ratio(p.grad.numpy(), want_grads[name].numpy()) <= GRAD_TOL, name


@pytest.mark.parametrize("modulated", [False, True])
def test_dfconv2d_at_init_is_the_plain_conv(modulated):
    """A zero ``offset_conv`` samples the kernel grid: v1 is the 3x3 conv with
    the same weights, v2 half of it (the mask is sigmoid(0))."""
    rs = np.random.RandomState(12)
    layer = DFConv2d(4, 6, modulated=modulated)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rs.randn(9, 4, 6).astype(np.float32)))
        layer.bias.zero_()
    x = torch.from_numpy(rs.randn(2, 4, 7, 9).astype(np.float32))
    with torch.no_grad():
        got = layer(x)
    w_oihw = layer.weight.detach().permute(2, 1, 0).reshape(6, 4, 3, 3)
    want = F.conv2d(x, w_oihw, padding=1) * (0.5 if modulated else 1.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FWD_TOL)


def test_deform_conv_layer_on_shared_samples():
    """``DeformConvLayer`` on precomputed samples is its own gather + matmul."""
    x, off, *_ = case(13)
    layer = DeformConvLayer(6, 3)
    with torch.no_grad():
        layer.weight.normal_(generator=torch.Generator().manual_seed(0))
        layer.bias.fill_(0.25)
    tx, toff = torch.from_numpy(x), torch.from_numpy(off)
    with torch.no_grad():
        a = layer(tx, toff)
        b = layer(samples=tdc.deform_sample_batched(tx, toff))
    assert torch.equal(a, b) and a.shape == (2, 5, 7, 3)


# ------------------------------------------------------------ the DCN options
def _randomize_offsets(variables, seed):
    """numpy copy of a Flax tree with FrozenBN buffers away from identity and
    every ``offset_conv`` drawn (zero at init): a small position-dependent
    kernel and a per-channel bias of 1.5 pixels, so that samples are
    fractional and some fall outside the map."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    n_offset = 0

    def walk(tree, in_buffers):
        nonlocal n_offset
        for k, v in tree.items():
            if not isinstance(v, dict):
                continue
            if in_buffers and set(v) == {"scale", "bias"}:
                v["scale"] = rs.uniform(0.75, 1.25, v["scale"].shape).astype(np.float32)
                v["bias"] = (rs.randn(*v["bias"].shape) * 0.05).astype(np.float32)
            elif k == "offset_conv":
                v["kernel"] = (rs.randn(*v["kernel"].shape) * 0.003).astype(np.float32)
                v["bias"] = (rs.randn(*v["bias"].shape) * 1.5).astype(np.float32)
                n_offset += 1
            else:
                walk(v, in_buffers)

    walk(out["params"], False)
    walk(out.get("buffers", {}), True)
    assert n_offset > 0
    return out


def _model_cfg(get_cfg, yaml, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / yaml))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def _forward_pair(yaml, seed, **overrides):
    """The JAX module's and the port's outputs on one batch, same weights."""
    det = jax_build_model(_model_cfg(jax_get_cfg, yaml, **overrides))
    variables = _randomize_offsets(det.init_variables(jax.random.PRNGKey(seed)), seed)
    model = torch_build_model(_model_cfg(torch_get_cfg, yaml, **overrides), device="cpu")
    load_flax_variables(model, variables)
    images = np.random.RandomState(seed).randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    want = jax.jit(det.module.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                     jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    return model, got, want


def _assert_levels_match(got, want):
    for part, (g_l, w_l) in enumerate(zip(got, want)):
        for lvl, (g, w) in enumerate(zip(g_l, w_l)):
            assert tuple(g.shape) == w.shape, (part, lvl)
            assert ratio(g.numpy(), w) <= MODEL_TOL, (part, lvl)


@pytest.mark.usefixtures("default_torch_threads")   # one thread moves it past its tolerance
def test_deformable_conv_retinanet_matches_jax():
    model, got, want = _forward_pair("configs/retina/retinanet_dc_R_50_FPN_1x.yaml", 20,
                                     **{"MODEL.RESNETS.DEPTH": 18})
    assert type(model).__name__ == "DeformableConvRetinaNet"
    subnets = [m for n, m in model.head.named_children() if "subnet" in n]
    assert len(subnets) == 8 and all(isinstance(m, DFConv2d) and m.modulated for m in subnets)
    _assert_levels_match(got, want)


@pytest.mark.parametrize("v2", [False, True])
def test_fcos_dcn_tower_matches_jax(v2):
    model, got, want = _forward_pair("configs/fcos/fcos_R_50_FPN_1x.yaml", 21 + v2, **{
        "MODEL.RESNETS.DEPTH": 18, "MODEL.FCOS.USE_DCN_IN_TOWER": True,
        "MODEL.FCOS.USE_DCN_V2": v2})
    last = model.head.cls_tower3
    assert isinstance(last, DFConv2d) and last.modulated == v2
    assert not isinstance(model.head.bbox_tower2, DFConv2d)
    _assert_levels_match(got, want)


@pytest.mark.parametrize("modulated", [False, True])
def test_resnet_deform_stages_match_jax(modulated):
    """A narrow R-50 with conv2 deformable in res3-res5: every such block is
    a ``DFConv2d`` and none is fused, whatever FUSED_BLOCKS says; its FPN
    levels against the JAX backbone's."""
    over = {"MODEL.RESNETS.DEPTH": 50, "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
            "MODEL.RESNETS.RES2_OUT_CHANNELS": 32, "MODEL.RESNETS.STEM_OUT_CHANNELS": 16,
            "MODEL.FPN.OUT_CHANNELS": 32, "MODEL.RESNETS.FUSED_BLOCKS": True,
            "MODEL.RESNETS.DEFORM_ON_PER_STAGE": [False, True, True, True],
            "MODEL.RESNETS.DEFORM_MODULATED": modulated}
    yaml, seed = "configs/fcos/fcos_R_50_FPN_1x.yaml", 23 + modulated
    module = jax_build_model(_model_cfg(jax_get_cfg, yaml, **over)).backbone_spec.module
    x = np.random.RandomState(seed).randn(2, 64, 96, 3).astype(np.float32)
    variables = _randomize_offsets(
        jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    model = torch_build_model(_model_cfg(torch_get_cfg, yaml, **over), device="cpu")
    model.backbone.load_state_dict(flax_to_state_dict(variables))
    want = jax.jit(module.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                 jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    blocks = {n: m for n, m in model.backbone.bottom_up.named_children() if n.startswith("res")}
    deform = sorted(n for n, m in blocks.items() if isinstance(m.conv2, DFConv2d))
    assert len(deform) == 13 and not any(n.startswith("res2") for n in deform)
    assert all(blocks[n].conv2.modulated == modulated for n in deform)
    assert sorted(n for n, m in blocks.items() if m.fused_eligible()) == [
        "res2_0", "res2_1", "res2_2"]
    assert sorted(got) == sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    for k in want:
        assert ratio(got[k].permute(0, 2, 3, 1).numpy(), want[k]) <= MODEL_TOL, k
