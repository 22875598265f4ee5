"""The PyTorch port's CornerNet held against the JAX package's on the CPU,
in float32, at a tiny width: ``configs/corner/corner_net_hourglass.yaml``
with 2 stacks (so the inter-stack fusion and the two-stack supervision
run), DEPTH_BLOCK 3, CHANNELS_BLOCK [64, 64, 96, 96], NUM_CONV_BLOCK [1, 1,
1, 2], 8 classes and 64 x 64 images; trainable BatchNorm in the trunk,
FrozenBN in the heads, all drawn away from identity, weights carried from
the JAX tree by ``checkpoint/bridge.py``:

- the Hourglass's outputs and the heatmaps within 1e-5 of the largest
  value, the tags and offsets within 2e-5 (running statistics);
- ``render_corner_targets``, the JAX function compiled at XLA's
  optimisation level 0: the corners bit for bit; the heatmaps within 1e-5
  relative (XLA's CPU code for the division fused into ``exp`` moves a
  gaussian's argument by an ulp or two, 7.6e-6 of the value at exp(-53);
  its ``exp`` alone is within an ulp of torch's), and bit for bit when the
  JAX function is given torch's ``exp``; subnormals flushed (XLA's CPU
  flushes them);
- each loss term within 1e-5 and the running statistics one loss leaves
  within 1e-5, with the gts a mix of corners on the stride-4 grid (the
  focal loss's positives) and off it (non-zero offsets); every gradient
  within 1e-4 of its tensor's largest with both packages in float64 (in
  float32 both round near-ties in the max and corner pools each its own
  way), and in float32 within 1e-4 plus twice the port's own float32
  error;
- ``predict`` against ``jax.jit(det.predict)`` with ``TPU.APPROX_TOPK``
  off: the valid counts and classes equal, boxes and scores within
  rounding; the decode of one set of head outputs in both packages: valid
  slots, classes and boxes equal, scores within two ulps (XLA's and
  torch's sigmoids differ by ulps); more than K = 100 non-zero peaks an
  image and side after the 3 x 3 NMS, so that the corner top-k has no
  ties at zero (``torch.topk`` orders ties unlike ``jax.lax.top_k``);
- one ADAM step against optax's (the yaml's optimizer);
- ``TPU.REMAT_BACKBONE`` on and off for the Hourglass and a BN ResNet: the
  same state-dict keys, loss, gradients and running statistics, with
  ``backward()`` called after ``loss`` returns, as ``TrainStep`` does;
- the registry's 28 names, the full-width yaml, the divisibility check;
- two gloo ranks on the halves of a joined batch with unequal gt counts:
  the joined batch's loss, counts and BatchNorm statistics;
- ``train_net_torch.main``: 2 iterations and a save, ``--resume`` to 4,
  bit-equal (BatchNorm statistics and ADAM moments included) to a run
  that went 0 -> 4, then ``--eval-only``.

Every input comes from a numpy seed inside its test; the JAX detector and
its randomised tree are made once a module (the tree drawn in numpy on
``jax.eval_shape`` of ``init_variables``).
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import ddp_workers  # noqa: E402
from synthetic import make_coco_json  # noqa: E402

import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.layers import BatchNorm  # noqa: E402
from slenderobjdet_torch.models.meta_arch import corner_net as tcn  # noqa: E402
from slenderobjdet_torch.parallel import launch  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import META_ARCH_REGISTRY  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models import layers as jlayers  # noqa: E402
from slenderobjdet_tpu.models.backbones import hourglass as jhourglass  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import corner_net as jcn  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/corner/corner_net_hourglass.yaml"
FCOS_CONFIG = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
TINY = {"MODEL.HOURGLASS.DEPTH_BLOCK": 3, "MODEL.HOURGLASS.CHANNELS_BLOCK": [64, 64, 96, 96],
        "MODEL.HOURGLASS.NUM_CONV_BLOCK": [1, 1, 1, 2], "MODEL.CORNER_NET.NUM_CLASSES": 8,
        "TPU.COMPUTE_DTYPE": "float32", "TPU.APPROX_TOPK": False}
OUT_RATIO = 1e-5      # max |diff| / max |JAX value|: trunk outputs and heatmaps
# the tag and offset outputs (1 and 2 channels, 60 layers deep): the second
# stack's offsets differ by 1.1e-5 of their largest value
SMALL_OUT_RATIO = 2e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4       # per tensor, max |diff| / max |JAX gradient|
FP32_TIE_FREE = 1e-5  # a float32 gradient this close to float64: no near-tie moved it
STAT_RATIO = 1e-5     # running statistics, per tensor
HW = (64, 64)
NUM_CLASSES = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: under the tier's six
    workers on one shared CPU, eight threads a process make the port's many
    small operations wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg, config=CONFIG, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(config))
    cfg.merge_from_list([x for kv in {**TINY, **overrides}.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def draw_tree(shapes, seed):
    """A numpy Flax tree on ``shapes``: conv kernels lecun-normal (the tag
    and offset outputs' a twentieth of it, so that tags lie within 0.5 of
    each other often enough for TL x BR pairs to form), conv biases
    normal(0, 0.01) but the heat prior, BatchNorm scale, bias, mean and var
    and FrozenBN scale and bias away from identity."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        shape, name, parent = leaf.shape, keys[-1], keys[-2]
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(shape[:-1]))
            if parent in ("tag_out", "offset_out"):
                std *= 0.05            # tags and offsets of a few tenths: pairs form
            return (rs.randn(*shape) * std).astype(np.float32)
        if keys[0] == "buffers" and parent.startswith("FrozenBatchNorm"):
            return (rs.uniform(0.75, 1.25, shape) if name == "scale"
                    else rs.randn(*shape) * 0.05).astype(np.float32)
        if keys[0] == "buffers":
            return (rs.randn(*shape) * 0.1 if name == "mean"
                    else rs.uniform(0.5, 1.5, shape)).astype(np.float32)
        if parent.startswith("BatchNorm"):
            return (rs.uniform(0.8, 1.2, shape) if name == "scale"
                    else rs.randn(*shape) * 0.1).astype(np.float32)
        if parent == "heat_out":
            return np.full(shape, -np.log(9.0), np.float32)
        return (rs.randn(*shape) * 0.01).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    """The JAX detector and its drawn tree, the running statistics set by
    the JAX package's ``precise_bn_stats`` over one batch (drawn running
    statistics leave the activations unnormalised through 60 layers)."""
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    shapes = jax.eval_shape(det.init_variables, jax.random.PRNGKey(0))
    variables = draw_tree(shapes, 20)
    images = np.random.RandomState(19).randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    buffers = jlayers.precise_bn_stats(det.module, jtree(variables), [images])
    variables["buffers"] = jax.tree_util.tree_map(np.asarray, buffers)
    return {"det": det, "variables": variables}


def port_model(variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def jtree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def gt_boxes(rs, batch, g, hw=HW):
    """Boxes of 10-40 px, corners on the stride-4 grid in every other row
    (the focal loss's positives) and anywhere in the others."""
    xy = rs.uniform(0, hw[1] - 42, (batch, g, 2))
    wh = rs.uniform(10, 40, (batch, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, ::2] = np.round(boxes[:, ::2] / 4) * 4
    return boxes.astype(np.float32)


def train_batch(seed, batch=2, g=6):
    """uint8 images, gt boxes of ``gt_boxes``, the last row padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, -1] = False
    return {"image": rs.randint(0, 256, (batch, *HW, 3)).astype(np.uint8),
            "gt_boxes": gt_boxes(rs, batch, g),
            "gt_classes": rs.randint(0, NUM_CLASSES, (batch, g)).astype(np.int32),
            "gt_valid": valid}


def predict_batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, *HW, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([HW, [51, 49]], np.float32)}


# ------------------------------------------------------------ registry, build
def test_registry_holds_all_twenty_eight_names():
    assert len(META_ARCHS) == 28 and set(META_ARCHS) == set(META_ARCH_REGISTRY.keys())
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    assert type(model) is tcn.CornerNet and model.size_divisibility == 32
    model = torch_build_model(tiny_cfg(torch_get_cfg, **{"TPU.INT8_PREDICT": True}), device="cpu")
    assert type(model) is tcn.CornerNet and model.int8_predict


def test_corner_yaml_builds_at_full_width():
    """The yaml as written (2 stacks, DEPTH_BLOCK 5, channels 256-512, BN
    trunk, FrozenBN heads, bf16, 80 classes): Hourglass-104's 200 million
    parameters, a size divisibility of 128, which both loader buckets
    (896 x 1408, 1408 x 896) meet."""
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.freeze()
    model = torch_build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16 and model.size_divisibility == 128
    assert all(hw % 128 == 0 for hw in (896, 1408))
    n = sum(p.numel() for p in model.parameters())
    assert 190e6 < n < 215e6, n
    assert isinstance(model.backbone.hg1.HourglassBlock_0.Residual_0.ConvBNRelu_0.norm, BatchNorm)
    assert type(model.tl_head1.pool_conv1.norm).__name__ == "FrozenBatchNorm"
    assert model.tl_head0.heat_out.out_channels == 80
    assert float(model.br_head1.heat_out.bias[0]) == pytest.approx(-np.log(9.0))


def test_hourglass_refuses_an_input_it_does_not_divide():
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    with pytest.raises(ValueError, match="size_divisibility 32"):
        model(torch.zeros(1, 64, 80, 3, dtype=torch.uint8))


def test_bridge_carries_the_tree(setup):
    variables = setup["variables"]
    model = port_model(variables)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(flax_to_state_dict(variables)) == len(leaves) == len(model.state_dict())
    bn = variables["buffers"]["backbone"]["hg1"]["HourglassBlock_0"]["Residual_1"]
    np.testing.assert_array_equal(
        model.backbone.hg1.HourglassBlock_0.Residual_1.ConvBNRelu_2.norm.running_var.numpy(),
        bn["ConvBNRelu_2"]["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(
        model.br_head0.pool_out.norm.scale.numpy(),
        variables["buffers"]["br_head0"]["pool_out"]["FrozenBatchNorm_0"]["scale"])
    np.testing.assert_array_equal(
        model.backbone.inter_a0.conv.weight.detach().numpy(),
        variables["params"]["backbone"]["inter_a0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


# ------------------------------------------------------------ network
def test_trunk_and_heads_match_jax(setup):
    det, variables = setup["det"], setup["variables"]
    images = train_batch(21)["image"]
    (outs, state) = jax.jit(lambda v, x: det.module.apply(
        v, x, capture_intermediates=True, mutable=["intermediates"]))(
        jtree(variables), jnp.asarray(images))
    want_feats = state["intermediates"]["backbone"]["__call__"][0]
    model = port_model(variables)
    with torch.no_grad():
        x = (torch.from_numpy(images).float() - model.pixel_mean) / model.pixel_std
        feats = model.backbone(x.permute(0, 3, 1, 2))
        got = model(torch.from_numpy(images))
    assert sorted(feats) == sorted(want_feats) == ["hourglass2", "hourglass3"]
    for k, f in feats.items():
        assert ratio(f.permute(0, 2, 3, 1).numpy(), want_feats[k]) <= OUT_RATIO, k
    for stack_got, stack_want in zip(got, outs):
        for side_got, side_want in zip(stack_got, stack_want):
            for g, w, tol in zip(side_got, side_want, (OUT_RATIO, SMALL_OUT_RATIO,
                                                       SMALL_OUT_RATIO)):
                assert tuple(g.shape) == w.shape
                assert ratio(g.numpy(), w) <= tol


# ------------------------------------------------------------ targets
def _render_pair(batch):
    """The port's targets and the inputs of the JAX function (per image)."""
    args = [torch.from_numpy(batch[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")]
    return tcn.render_corner_targets((16, 16), 4, *args, NUM_CLASSES)


def _jax_render(batch, exact=False):
    def fn(b, c, v):
        return jax.vmap(lambda b_, c_, v_: jcn.render_corner_targets(
            (16, 16), 4, b_, c_, v_, NUM_CLASSES))(b, c, v)

    args = [jnp.asarray(batch[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")]
    if not exact:
        return [np.asarray(a) for a in jax.jit(fn)(*args)]
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return [np.asarray(a) for a in compiled(*args)]


def test_render_corner_targets_match_jax():
    batch = train_batch(22, g=12)
    batch["gt_classes"][0, :4] = 3                    # one class holds several gts
    got = [t.numpy() for t in _render_pair(batch)]
    want = _jax_render(batch, exact=True)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)            # corners
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(flush_subnormals(g), w, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(g >= 0.999, w >= 0.999)
        assert (w >= 0.999).sum() >= 4 and (w > 0).mean() > 0.05


def flush_subnormals(a):
    """XLA on the CPU flushes float32 subnormals to zero (the tail of a
    gaussian, exp below -87.3); torch keeps them."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, np.float32(0), a)


class _TorchExpJnp:
    """``jax.numpy`` with ``exp`` computed by torch on the host."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jax.pure_callback(
            lambda a: torch.exp(torch.from_numpy(np.asarray(a))).numpy(),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x, vmap_method="expand_dims")


def test_render_corner_targets_equal_jax_bit_for_bit_given_one_exp(monkeypatch):
    """Everything but ``exp`` (the distances, the radii, the mask and the
    per-class max by ``scatter_reduce``) bit for bit, subnormals flushed."""
    batch = train_batch(23, g=12)
    batch["gt_classes"][1, :5] = 6
    batch["gt_classes"][1, 5] = 99                    # out of range: no heat, as one_hot
    monkeypatch.setattr(jcn, "jnp", _TorchExpJnp())
    want = _jax_render(batch, exact=True)
    for g, w in zip(_render_pair(batch), want):
        np.testing.assert_array_equal(flush_subnormals(g.numpy()), w)


# ------------------------------------------------------------ losses
def jax_loss_batch():
    return train_batch(24)


@pytest.fixture(scope="module")
def jax_loss(setup):
    """The JAX loss, its metrics, the buffers its apply wrote and the
    gradients on one batch."""
    det, jv = setup["det"], jtree(setup["variables"])
    batch = jax_loss_batch()

    def loss_fn(params):
        return det.loss({"params": params, "buffers": jv["buffers"]},
                        {k: jnp.asarray(v) for k, v in batch.items()})

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
    return {"batch": batch, "total": float(total),
            "metrics": {k: float(v) for k, v in metrics.items() if not k.startswith("_")},
            "buffers": jax.tree_util.tree_map(np.asarray, metrics["_buffers"]),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def port_grads(variables, batch, dtype=torch.float32):
    """The port's loss, metrics, model and gradients (float64 copies) on
    ``batch`` in ``dtype``."""
    model = port_model(variables)
    if dtype == torch.float64:
        model.double()
        model.dtype = torch.float64
    tsolver.build_optimizer(tiny_cfg(torch_get_cfg), model)
    total, metrics = model.loss(batch)
    total.backward()                       # after loss returned, as TrainStep does
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return total, metrics, model, grads


def test_loss_terms_gradients_and_statistics_match_jax(setup, jax_loss):
    """In float32: loss terms within 1e-5, running statistics within 1e-5,
    and every gradient within 1e-4 of its tensor's largest plus twice
    float32's own error on this loss (the port's float32 gradient against
    its float64 one): the max pools, the corner pools and the ReLUs hold
    near-ties that float32 rounding resolves one way or the other, and
    where it does the gradient moves by up to a few percent in both
    packages (float32 against float64, 64 x 64 at B = 2). Every tensor
    whose float32 error is below 1e-5 is held to 1e-4 alone; the float64
    test below holds every tensor to 1e-4."""
    want = jax_loss
    total, metrics, model, grads = port_grads(setup["variables"], want["batch"])
    assert sorted(metrics) == sorted(want["metrics"])
    assert float(total.detach()) == pytest.approx(want["total"], rel=LOSS_RTOL)
    for k, v in want["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=LOSS_RTOL), k
    assert float(metrics["num_pos"]) == 10 and float(metrics["loss_offset"]) > 0
    stats = flax_to_state_dict({"params": setup["variables"]["params"],
                                "buffers": want["buffers"]})
    buffers = dict(model.named_buffers())
    moved = 0
    for k, v in stats.items():
        if k in buffers:
            assert ratio(buffers[k].numpy(), v.numpy()) <= STAT_RATIO, k
            moved += k.endswith("running_mean")
    assert moved == sum(isinstance(m, BatchNorm) for m in model.modules()) > 50
    _, _, _, grads64 = port_grads(setup["variables"], want["batch"], torch.float64)
    jgrads = flax_to_state_dict({"params": want["grads"]})
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        own = ratio(g, grads64[name])
        bound = GRAD_TOL if own < FP32_TIE_FREE else GRAD_TOL + 2 * own
        assert ratio(g, jgrads[name].numpy()) <= bound, name


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``: put in place
    of the module global ``jnp`` of the JAX layers, trunk and CornerNet, it
    makes their explicit float32 casts (BatchNorm's statistics, the heads'
    outputs, the target grids) float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture(scope="module")
def jax_grads64(setup):
    """The JAX loss and gradients on ``jax_loss``'s batch with x64 on, the
    module cloned at float64 and every float32 cast float64."""
    det, batch = setup["det"], jax_loss_batch()
    module = det.module
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for m in (jlayers, jhourglass, jcn):
            mp.setattr(m, "jnp", _Float64Numpy())
        mp.setattr(det, "module", module.clone(
            dtype=jnp.float64, backbone=module.backbone.clone(dtype=jnp.float64)))
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                    setup["variables"])

        def loss_fn(params):
            return det.loss({"params": params, "buffers": jv["buffers"]},
                            {k: jnp.asarray(v) for k, v in batch.items()})

        (total, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
        assert total.dtype == jnp.float64
        return {"total": float(total), "grads": jax.tree_util.tree_map(
            lambda g: np.asarray(g, np.float64), grads)}


def test_gradients_match_jax_in_float64(setup, jax_grads64):
    """Both packages in float64 on the float32 test's batch and weights
    (no near-tie in a pool is resolved by rounding there): the loss within
    1e-5 and every parameter's gradient within 1e-4 of its tensor's
    largest."""
    want = jax_grads64
    total, _, _, grads = port_grads(setup["variables"], jax_loss_batch(), torch.float64)
    assert float(total.detach()) == pytest.approx(want["total"], rel=LOSS_RTOL)
    jgrads = {k: v.numpy() for k, v in flax_to_state_dict({"params": want["grads"]}).items()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        assert ratio(g, jgrads[name]) <= GRAD_TOL, name


def test_one_adam_step_matches_optax(setup, jax_loss):
    """The yaml's ADAM at BASE_LR 2.5e-4 (no warm-up) through the port's
    train step, fed the JAX loss's gradients (the step's loss is replaced by
    one whose gradient they are), against optax's update from the same
    parameters: every parameter within 1e-5 of ADAM's first step, the LR."""
    over = {"SOLVER.WARMUP_ITERS": 0}
    cfg, jcfg = tiny_cfg(torch_get_cfg, **over), tiny_cfg(jax_get_cfg, **over)
    model = port_model(setup["variables"])
    jgrads = {k: torch.from_numpy(v.numpy()) for k, v in
              flax_to_state_dict({"params": jax_loss["grads"]}).items()}
    params = dict(model.named_parameters())
    model.loss = lambda batch: (sum((params[k] * g).sum() for k, g in jgrads.items()), {})
    old = {k: v.detach().clone() for k, v in params.items()}
    make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)(jax_loss["batch"])
    jparams = jtree(setup["variables"]["params"])
    tx = jsolver.build_optimizer(jcfg, jparams)
    updates, _ = tx.update(jtree(jax_loss["grads"]), tx.init(jparams), jparams)
    want_new = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jparams, updates))})
    lr = cfg.SOLVER.BASE_LR
    for name, p in params.items():
        delta = (p.detach() - old[name]).numpy()
        want_delta = want_new[name].numpy() - old[name].numpy()
        ulp = 2 * np.spacing(np.abs(old[name].numpy()).max())
        assert np.abs(delta).max() <= lr * 1.001 + ulp, name
        np.testing.assert_allclose(delta, want_delta, rtol=0, atol=1e-5 * lr + ulp,
                                   err_msg=name)
    assert np.abs(want_delta).max() > 0.5 * lr


# ------------------------------------------------------------ predict
def test_predict_matches_jax(setup):
    det, variables = setup["det"], setup["variables"]
    batch = predict_batch(25)
    want = {k: np.asarray(v) for k, v in jax.jit(det.predict)(
        jtree(variables), {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    got = {k: v.numpy() for k, v in port_model(variables).predict(batch).items()}
    assert sorted(got) == sorted(want)
    valid = want["valid"]
    assert valid.sum(1).min() >= 5
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["classes"][valid], want["classes"][valid])
    np.testing.assert_allclose(got["scores"][valid], want["scores"][valid], rtol=1e-5)
    np.testing.assert_allclose(got["boxes"][valid], want["boxes"][valid], rtol=0, atol=1e-3)


def test_predict_computes_the_last_stack_only(setup):
    """``predict`` runs the last stack's heads alone (the first stack's are
    training's intermediate supervision): its head outputs equal those of
    the full forward, and so do its detections."""
    model = port_model(setup["variables"])
    batch = predict_batch(28)
    images = torch.from_numpy(batch["image"])
    with torch.no_grad():
        full = model(images)
        last = model(images, stacks=[1])
    assert len(full) == 2 and len(last) == 1
    for g, w in zip(last[0][0] + last[0][1], full[1][0] + full[1][1]):
        assert torch.equal(g, w)
    got = model.predict(batch)
    want = model.detections(*full[1], torch.from_numpy(batch["scale"]),
                            torch.from_numpy(batch["orig_size"]))
    assert all(torch.equal(got[k], want[k]) for k in want)


class _Outputs:
    """A stand-in for the JAX ``CornerNetModule`` that returns fixed head
    outputs, so that the JAX ``predict`` decodes exactly these."""

    def __init__(self, outs):
        self.outs = outs

    def apply(self, variables, images):
        return self.outs


def test_decode_equals_jax_on_shared_head_outputs(setup):
    """One set of head outputs decoded by both packages: the valid slots,
    their classes and boxes equal, scores within two ulps."""
    variables = setup["variables"]
    batch = predict_batch(26)
    outs = jax.jit(setup["det"].module.apply)(jtree(variables), jnp.asarray(batch["image"]))
    tl, br = outs[-1]
    peaks = []
    for heat in (tl[0], br[0]):
        p = jax.nn.sigmoid(heat)
        pooled = jax.lax.reduce_window(p, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 1, 1, 1),
                                       "SAME")
        peaks.append(np.asarray(jnp.sum(p == pooled, axis=(1, 2, 3))))
    assert np.min(peaks) > tcn.TOPK_CORNERS, peaks
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    det.module = _Outputs(outs)
    want = {k: np.asarray(v) for k, v in jax.jit(det.predict)(
        jtree(variables), {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    model = port_model(variables)

    def side(o):
        return tuple(torch.from_numpy(np.asarray(t)) for t in o)

    got = {k: v.numpy() for k, v in model.detections(
        side(tl), side(br), torch.from_numpy(batch["scale"]),
        torch.from_numpy(batch["orig_size"])).items()}
    valid = want["valid"]
    assert valid.sum() >= 10
    np.testing.assert_array_equal(got["valid"], valid)
    for k in ("classes", "boxes"):
        np.testing.assert_array_equal(got[k][valid], want[k][valid])
    np.testing.assert_array_max_ulp(got["scores"][valid], want["scores"][valid], maxulp=2)


# ------------------------------------------------------------ remat
REMAT_CASES = {
    "hourglass": (CONFIG, TINY),
    "resnet": (FCOS_CONFIG, {"MODEL.RESNETS.DEPTH": 18, "MODEL.RESNETS.NORM": "BN",
                             "TPU.COMPUTE_DTYPE": "float32"}),
}


@pytest.mark.parametrize("trunk", sorted(REMAT_CASES))
def test_remat_backbone_keeps_keys_loss_gradients_and_statistics(trunk):
    """``TPU.REMAT_BACKBONE`` recomputes each residual in the backward. With
    it on and off, from the same seed: the same state-dict keys, the same
    loss, gradients within 5e-4 / 1e-4 (rtol / atol) and running
    statistics within 1e-5 / 1e-7, ``backward()`` being called after
    ``loss`` has left its batch-statistics context. A recompute that
    normalised by the running statistics would move the gradients; one that
    updated the running statistics again would move them."""
    config, over = REMAT_CASES[trunk]
    batch = train_batch(27)
    runs = []
    for remat in (False, True):
        cfg = torch_get_cfg()
        cfg.merge_from_file(str(config))
        cfg.merge_from_list([x for kv in {**over, "TPU.REMAT_BACKBONE": remat}.items()
                             for x in kv])
        cfg.freeze()
        model = torch_build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        tsolver.build_optimizer(cfg, model)
        total, _ = model.loss(batch)
        total.backward()
        runs.append((model, float(total.detach())))
    (m0, t0), (m1, t1) = runs
    assert m1.backbone.remat if trunk == "hourglass" else m1.backbone.bottom_up.remat
    assert list(m0.state_dict()) == list(m1.state_dict())
    assert t0 == t1
    p1 = dict(m1.named_parameters())
    for name, p in m0.named_parameters():
        if p.grad is None:
            assert p1[name].grad is None, name
            continue
        np.testing.assert_allclose(p1[name].grad.numpy(), p.grad.numpy(), rtol=5e-4,
                                   atol=1e-4, err_msg=name)
    b1 = dict(m1.named_buffers())
    for name, b in m0.named_buffers():
        np.testing.assert_allclose(b1[name].numpy(), b.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert not torch.equal(b1[[k for k in b1 if k.endswith("running_var")][-1]],
                           torch.ones_like(b1[[k for k in b1 if k.endswith("running_var")][-1]]))


# ---------------------------------------------------------- two ranks
def test_two_gloo_ranks_take_the_joined_batch_step():
    """Two gloo ranks (``parallel.launch``, ``tests/ddp_workers.py``) on the
    halves of a joined batch of 4 images whose halves hold 1 and 4 gts an
    image, against this process's step on the joined batch: the ranks'
    models bit-equal after the step, each rank's ``num_pos`` the joined
    batch's, the mean of their losses its loss within 1e-5, and the
    BatchNorm running statistics (reduced over the group) its own within
    1e-5. A rank normalising by its own half's counts, or by its half's
    batch statistics, would fail each."""
    rs = np.random.RandomState(29)
    joined = train_batch(29, batch=4, g=5)
    joined["gt_valid"][:] = np.arange(5)[None] < np.array([1, 1, 4, 4])[:, None]
    joined["gt_boxes"] = gt_boxes(rs, 4, 5)
    spec = {"yaml": str(CONFIG.relative_to(ROOT)), "overrides": TINY, "seed": 5, "steps": 1}
    threads = torch.get_num_threads()
    torch.set_num_threads(ddp_workers.THREADS)
    try:
        model, step = ddp_workers.build_family(spec)
        want = {k: float(v) for k, v in step(dict(joined)).items()}
    finally:
        torch.set_num_threads(threads)
    ranks = launch(ddp_workers.run_families, 2, args=({"CornerNet": spec}, [joined]),
                   backend="gloo", timeout=ddp_workers.GROUP_TIMEOUT,
                   join_timeout=ddp_workers.JOIN_TIMEOUT)
    r0, r1 = (r["CornerNet"] for r in ranks)
    assert r0["digest"] == r1["digest"]
    got = [r["metrics"][0] for r in (r0, r1)]
    assert got[0]["num_pos"] == got[1]["num_pos"] == want["num_pos"] == 10
    assert (got[0]["total_loss"] + got[1]["total_loss"]) / 2 == pytest.approx(
        want["total_loss"], rel=LOSS_RTOL)
    running = {k: v for k, v in model.named_buffers() if "running_" in k}
    assert sorted(r0["running"]) == sorted(running)
    for k, v in running.items():
        assert ratio(r0["running"][k].numpy(), v.numpy()) <= STAT_RATIO, k


# ---------------------------------------------------------- the entry point
NAME = "torch_cornernet_synth"
TINY_MAIN = {
    **TINY, "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.WARMUP_ITERS": 3,
    "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cornernet")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    tcatalog.DatasetCatalog.remove(NAME)
    tcoco.register_coco_instances(NAME, path, root)
    return tmp


def cli_args(out, *flags, **overrides):
    opts = {**TINY_MAIN, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(CONFIG), *flags] + [str(x) for kv in opts.items() for x in kv])


def test_main_trains_resumes_bit_equal_and_evaluates(synth, monkeypatch):
    """2 iterations and a checkpoint, ``--resume`` to 4, against a run that
    went 0 -> 4 on the same batches: the model (the BatchNorm running
    statistics included), ADAM's moments and step, and the iteration equal
    bit for bit; then ``--eval-only``."""
    k, n = 2, 4
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
    key = "backbone.hg1.HourglassBlock_0.Residual_0.ConvBNRelu_0.norm.running_var"
    assert float(saved["model"][key].mean()) != 1.0
    train_net_torch.main(cli_args(out, "--device", "cpu", "--resume",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    assert trainers[1].start_iter == k

    real_loader = ttrainer.build_detection_train_loader

    def restarting_loader(cfg, seed=0, **kw):
        def stream():
            head = iter(real_loader(cfg, seed=seed, **kw))
            for _ in range(k):
                yield next(head)
            yield from real_loader(cfg, seed=seed, **kw)
        return stream()

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", restarting_loader)
    train_net_torch.main(cli_args(synth / "straight", "--device", "cpu",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    assert sorted(got["model"]) == sorted(want["model"])
    for name in got["model"]:
        assert torch.equal(got["model"][name], want["model"][name]), name
    assert not torch.equal(got["model"][key], saved["model"][key])
    for s_got, s_want in zip(got["optimizer"]["state"].values(),
                             want["optimizer"]["state"].values()):
        assert sorted(s_got) == ["exp_avg", "exp_avg_sq", "step"]
        for name in s_got:
            assert torch.equal(s_got[name], s_want[name]), name

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", real_loader)
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **{"SOLVER.MAX_ITER": n}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]
