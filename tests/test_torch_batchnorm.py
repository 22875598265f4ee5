"""The PyTorch port's trainable BatchNorm held against the JAX package on the
CPU, in float32:

- ``BatchNorm`` alone against the JAX ``BatchNorm`` (mutable apply): batch-
  statistics outputs and running statistics, running-statistics outputs,
  and the gradients of input, scale and bias; a large-mean, small-variance
  input against float64 (the two-pass variance); one module applied to five
  pyramid levels in turn, the five-step update order included; a batch of
  one 1 x 1 cell, whose variance is exactly 0;
- ``get_norm`` for each name, and the R-18 + FPN backbone with
  ``MODEL.RESNETS.NORM`` BN, SyncBN and GN, and ``MODEL.FPN.NORM`` BN and
  GN, with weights through the bridge, against JAX with batch and with
  running statistics; the norm-free trunk, which the JAX package cannot
  build;
- ``FREEZE_AT`` leaving the stem's norm trainable, as the JAX mask does;
- ``precise_bn_stats`` against JAX's on the tiny RepPointsGenerator (a
  BatchNorm trunk and the head's BatchNorms shared by five levels), and
  ``Trainer.test`` with ``TEST.PRECISE_BN`` against the JAX trainer's;
- the checkpoint round trip of the running statistics, bit-equal.

Every input comes from a numpy seed inside its test.
"""

import os
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402
from test_torch_proposal import (STAT_RATIO, randomize, ratio, tiny_cfg,  # noqa: E402
                                 train_batch, tree)

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.checkpoint.checkpointer import DetectionCheckpointer  # noqa: E402
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models import layers as tlayers  # noqa: E402
from slenderobjdet_torch.models.backbones.fpn import build_backbone  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402
from slenderobjdet_tpu.engine import trainer as jtrainer  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models import layers as jlayers  # noqa: E402
from slenderobjdet_tpu.models.backbones.fpn import build_backbone as jax_build_backbone  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FCOS_YAML = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
OUT_TOL = dict(rtol=1e-5, atol=1e-5)      # a layer's outputs
LAYER_STAT_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_RATIO = 1e-5                         # a layer's gradients, of the largest
FEATURE_RATIO = 1e-4                      # a backbone level, of its largest value
BIG_HW = (192, 256)                       # P7 2 x 2: no two-value channel at B = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module (``test_torch_proposal.py``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the layer
def layer_pair(c, seed):
    """A JAX BatchNorm's variables (scale, bias, mean, var away from
    identity) and the port's BatchNorm holding the same."""
    rs = np.random.RandomState(seed)
    v = {"params": {"scale": rs.uniform(0.5, 1.5, c), "bias": rs.randn(c) * 0.2},
         "buffers": {"mean": rs.randn(c) * 0.3, "var": rs.uniform(0.5, 2.0, c)}}
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    bn = tlayers.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["buffers"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["buffers"]["var"]))
    return v, bn


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_layer_matches_jax_in_both_modes_with_gradients():
    c = 16
    v, bn = layer_pair(c, 1)
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 8, 8, c) * 1.5 + 0.4).astype(np.float32)
    g = rs.randn(2, 8, 8, c).astype(np.float32)
    jbn = jlayers.BatchNorm(c)

    def train(params, xx):
        y, mut = jbn.apply({"params": params, "buffers": v["buffers"]}, xx,
                           mutable=["buffers"])
        return jnp.sum(y * g), (y, mut["buffers"])

    (_, (want, want_stats)), (gp, gx) = jax.value_and_grad(train, argnums=(0, 1),
                                                           has_aux=True)(v["params"], x)
    tx = nchw(x).requires_grad_(True)
    with tlayers.batch_statistics():
        got = bn(tx)
    (got * nchw(g)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **OUT_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_stats["mean"], **LAYER_STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), want_stats["var"], **LAYER_STAT_TOL)
    assert ratio(tx.grad.permute(0, 2, 3, 1).numpy(), gx) <= GRAD_RATIO
    assert ratio(bn.weight.grad.numpy(), gp["scale"]) <= GRAD_RATIO
    assert ratio(bn.bias.grad.numpy(), gp["bias"]) <= GRAD_RATIO
    # outside the context: the running statistics, and nothing is updated
    stats = bn.running_var.clone()
    with torch.no_grad():
        got = bn(nchw(x))
    want = jbn.apply({"params": v["params"], "buffers": want_stats}, x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **OUT_TOL)
    assert torch.equal(bn.running_var, stats)
    # the module's training flag plays no part (build_model leaves .eval())
    bn.train()
    with torch.no_grad():
        assert torch.equal(bn(nchw(x)), got)


def test_large_mean_small_variance_is_two_pass():
    """x = 30 + 0.05 N(0, 1): E[x^2] - E[x]^2 would lose every digit of the
    variance in float32; the batch statistics stay within 1e-5 of float64
    in both packages (the unbiased running variance, momentum 0.1 from 0)."""
    c = 8
    v, bn = layer_pair(c, 3)
    v["buffers"] = {"mean": np.zeros(c, np.float32), "var": np.zeros(c, np.float32)}
    with torch.no_grad():
        bn.running_mean.zero_()
        bn.running_var.zero_()
    rs = np.random.RandomState(4)
    x = (30.0 + rs.randn(4, 16, 8, c) * 0.05).astype(np.float32)
    x64 = x.astype(np.float64).reshape(-1, c)
    var64 = x64.var(0, ddof=1)
    _, mut = jlayers.BatchNorm(c).apply(v, x, mutable=["buffers"])
    with torch.no_grad(), tlayers.batch_statistics():
        got = bn(nchw(x))
    for var in (bn.running_var.numpy(), np.asarray(mut["buffers"]["var"])):
        np.testing.assert_allclose(var / 0.1, var64, rtol=1e-5)
    assert bool(torch.isfinite(got).all())
    # the one-pass form is off by far more here
    one_pass = (x.reshape(-1, c) ** 2).mean(0) - x.reshape(-1, c).mean(0) ** 2
    assert np.abs(one_pass * 512 / 511 - var64).max() > 1e-2 * var64.max()


class _SharedLevels(fnn.Module):
    """One JAX BatchNorm applied to several levels in turn, as the RPG head
    applies each of its norms."""
    c: int

    @fnn.compact
    def __call__(self, xs):
        bn = jlayers.BatchNorm(self.c)
        return [bn(x) for x in xs]


def test_one_module_over_five_levels_updates_in_their_order():
    c = 8
    v, bn = layer_pair(c, 5)
    rs = np.random.RandomState(6)
    levels = [(rs.randn(2, s, s, c) * (1 + i) + i).astype(np.float32)
              for i, s in enumerate((8, 4, 2, 1, 1))]
    want, mut = _SharedLevels(c).apply({"params": {"BatchNorm_0": v["params"]},
                                        "buffers": {"BatchNorm_0": v["buffers"]}},
                                       levels, mutable=["buffers"])
    with torch.no_grad(), tlayers.batch_statistics():
        got = [bn(nchw(x)) for x in levels]
    for gl, wl in zip(got, want):
        np.testing.assert_allclose(gl.permute(0, 2, 3, 1).numpy(), np.asarray(wl), **OUT_TOL)
    stats = mut["buffers"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], **LAYER_STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], **LAYER_STAT_TOL)
    # five EMA steps, P3 first: another order ends elsewhere
    _, other = layer_pair(c, 5)
    with torch.no_grad(), tlayers.batch_statistics():
        for x in levels[::-1]:
            other(nchw(x))
    assert not np.allclose(other.running_mean.numpy(), stats["mean"], rtol=1e-3)


def test_batch_of_one_cell_has_zero_variance_and_stays_finite():
    """B = 1 at a 1 x 1 level: the batch variance is exactly 0, the output
    is the bias (as in JAX, up to the affine's rounding), and the running variance takes (1 - momentum) of itself."""
    c = 8
    v, bn = layer_pair(c, 7)
    x = np.random.RandomState(8).randn(1, 1, 1, c).astype(np.float32) * 3
    want, mut = jlayers.BatchNorm(c).apply(v, x, mutable=["buffers"])
    tx = nchw(x).requires_grad_(True)
    with tlayers.batch_statistics():
        got = bn(tx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **OUT_TOL)
    # the bias, up to the rounding of x * inv - mean * inv (inv ~ 1/sqrt(eps))
    np.testing.assert_allclose(got.detach().reshape(-1).numpy(), v["params"]["bias"],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["buffers"]["var"], **LAYER_STAT_TOL)
    assert bool(torch.isfinite(tx.grad).all()) and bool(torch.isfinite(bn.weight.grad).all())


def test_rpg_at_batch_one_trains_finite():
    """The tiny RPG with a BatchNorm trunk at B = 1, 64 x 64: P6 and P7 are
    1 x 1, so the head's norms see zero variance there; the loss and every
    gradient stay finite (the moment decode's std has its epsilon)."""
    cfg = tiny_cfg(torch_get_cfg, **{"MODEL.RESNETS.NORM": "SyncBN"})
    model = torch_build_model(cfg, device="cpu")
    total, metrics = model.loss(train_batch(9, batch=1))
    total.backward()
    assert np.isfinite(float(total.detach())) and float(metrics["num_pos"]) > 0
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)


# ------------------------------------------------------------ get_norm
@pytest.mark.parametrize("name,cls", [("", None), ("FrozenBN", "FrozenBatchNorm"),
                                      ("GN", "GroupNorm32"), ("BN", "BatchNorm"),
                                      ("SyncBN", "BatchNorm")])
def test_get_norm_builds_each_name_as_jax(name, cls):
    got, want = tlayers.get_norm(name, 32), jlayers.get_norm(name, 32)
    assert (got is None) == (want is None) == (cls is None)
    if cls is not None:
        assert type(got).__name__ == type(want).__name__ == cls


# ------------------------------------------------------------ backbones
def backbone_cfg(get_cfg, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(FCOS_YAML))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def backbone_pair(seed, **overrides):
    """The JAX backbone, its variables with every norm away from identity,
    and the port's backbone holding them."""
    spec = jax_build_backbone(backbone_cfg(jax_get_cfg, **overrides), dtype=jnp.float32)
    variables = jax.jit(spec.module.init)(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, 64, 64, 3), jnp.float32))
    rs = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf in ("scale", "var"):
            return rs.uniform(0.7, 1.3, a.shape).astype(np.float32)
        if leaf == "mean" or (leaf == "bias" and a.ndim == 1 and "fpn" not in str(path)):
            return (rs.randn(*a.shape) * 0.1).astype(np.float32)
        return np.asarray(a, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    model = build_backbone(backbone_cfg(torch_get_cfg, **overrides))
    load_flax_variables(model, variables)
    return spec.module, variables, model


def features_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert ratio(got[k].detach().permute(0, 2, 3, 1).numpy(), want[k]) <= tol, k


def check_backbone(seed, **overrides):
    module, variables, model = backbone_pair(seed, **overrides)
    x = np.random.RandomState(seed + 1).randn(2, 64, 64, 3).astype(np.float32)
    train = "BN" in str(overrides.values())
    want = jax.jit(module.apply)(tree(variables), jnp.asarray(x))
    with torch.no_grad():
        features_close(model(nchw(x)), want, FEATURE_RATIO)
    if not train:
        return model, variables
    want, mut = jax.jit(lambda v, xx: module.apply(v, xx, mutable=["buffers"]))(
        tree(variables), jnp.asarray(x))
    with torch.no_grad(), tlayers.batch_statistics():
        features_close(model(nchw(x)), want, FEATURE_RATIO)
    sd = flax_to_state_dict({"params": variables["params"],
                             "buffers": jax.tree_util.tree_map(np.asarray, mut["buffers"])})
    for name, b in model.named_buffers():
        if "running" in name:
            assert ratio(b.numpy(), sd[name].numpy()) <= STAT_RATIO, name
    return model, variables


@pytest.mark.parametrize("norm", ["BN", "SyncBN", "GN"])
def test_trunk_norm_builds_and_matches_jax(norm):
    """MODEL.RESNETS.NORM built through ``resnet_from_cfg`` (a refusal until
    now); FUSED_STEM / FUSED_BLOCKS on, which a non-FrozenBN trunk ignores."""
    model, variables = check_backbone(10, **{"MODEL.RESNETS.NORM": norm,
                                             "MODEL.RESNETS.FUSED_STEM": True,
                                             "MODEL.RESNETS.FUSED_BLOCKS": True})
    kind = tlayers.GroupNorm32 if norm == "GN" else tlayers.BatchNorm
    trunk = model.bottom_up
    assert isinstance(trunk.stem_norm, kind) and isinstance(trunk.res2_0.norm2, kind)
    assert isinstance(trunk.res3_0.shortcut_norm, kind)
    assert "GroupNorm32_0" in variables["params"]["bottom_up"] or \
        "BatchNorm_0" in variables["params"]["bottom_up"]


@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_fpn_norm_matches_jax(norm):
    model, _ = check_backbone(11, **{"MODEL.FPN.NORM": norm})
    assert isinstance(model.fpn_output2_norm, tlayers.GroupNorm32 if norm == "GN"
                      else tlayers.BatchNorm)
    assert model.fpn_lateral0.bias is None


def test_norm_free_trunk_builds_where_jax_cannot():
    """MODEL.RESNETS.NORM "": the JAX ResNet calls the None that get_norm
    returns and raises; the port's trunk has no norm and runs."""
    with pytest.raises(TypeError):
        spec = jax_build_backbone(backbone_cfg(jax_get_cfg, **{"MODEL.RESNETS.NORM": ""}))
        spec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    model = build_backbone(backbone_cfg(torch_get_cfg, **{"MODEL.RESNETS.NORM": ""}))
    assert model.bottom_up.stem_norm is None and model.bottom_up.res2_0.norm1 is None
    with torch.no_grad():
        out = model(torch.randn(1, 3, 64, 64))
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_freeze_at_masks_as_jax():
    """FREEZE_AT 2 freezes the stem conv and res2 but not the stem's norm,
    whose Flax path (bottom_up/BatchNorm_0) names no stem."""
    jcfg = tiny_cfg(jax_get_cfg, **{"MODEL.RESNETS.NORM": "BN"})
    det = jax_build_model(jcfg)
    params = det.init_variables(jax.random.PRNGKey(0))["params"]
    mask = flax_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.float32(m), jsolver._freeze_mask(jcfg, params))})
    cfg = tiny_cfg(torch_get_cfg, **{"MODEL.RESNETS.NORM": "BN"})
    model = torch_build_model(cfg, device="cpu")
    tsolver.build_optimizer(cfg, model)
    for name, p in model.named_parameters():
        assert p.requires_grad == bool(mask[name]), name
    assert model.backbone.bottom_up.stem_norm.weight.requires_grad
    assert not model.backbone.bottom_up.stem_conv1.weight.requires_grad
    labels = tsolver.param_labels(model)
    assert labels["backbone.bottom_up.res3_0.norm1.weight"] == "norm"
    assert labels["head.deltas_norm0.bias"] == "bias"


# ------------------------------------------------------------ PreciseBN
def rpg_bn_variables(seed):
    det = jax_build_model(tiny_cfg(jax_get_cfg, **{"MODEL.RESNETS.NORM": "SyncBN"}))
    return det, randomize(det.init_variables(jax.random.PRNGKey(seed)),
                          "RepPointsGenerator", seed)


def test_precise_bn_stats_matches_jax():
    """Two batches at 192 x 256 through the tiny RPG with a BatchNorm trunk:
    every running statistic, the head's (one module over five levels: the
    momentum-weighted mix of the levels' statistics) included."""
    det, variables = rpg_bn_variables(12)
    rs = np.random.RandomState(13)
    batches = [rs.randint(0, 256, (2, *BIG_HW, 3)).astype(np.uint8) for _ in range(2)]
    want = jlayers.precise_bn_stats(det.module, tree(variables), iter(batches))
    model = torch_build_model(tiny_cfg(torch_get_cfg, **{"MODEL.RESNETS.NORM": "SyncBN"}),
                              device="cpu")
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.named_buffers()}
    assert tlayers.precise_bn_stats(model, iter(batches))
    sd = flax_to_state_dict({"params": variables["params"],
                             "buffers": jax.tree_util.tree_map(np.asarray, want)})
    n = 0
    for name, b in model.named_buffers():
        if "running" in name:
            assert ratio(b.numpy(), sd[name].numpy()) <= STAT_RATIO, name
            assert not torch.equal(b, before[name]), name
            n += 1
    assert n == 2 * (20 + 6)        # R-18: stem, 8 blocks' 19 norms; the head's 6
    # a model with no BatchNorm: nothing to do
    fcos = torch_build_model(tiny_cfg(torch_get_cfg, "ProposalNetworkWithMasks"), device="cpu")
    assert not tlayers.has_batch_stats(fcos)
    assert not tlayers.precise_bn_stats(fcos, iter(batches))


NAME = "torch_batchnorm_synth"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_batchnorm")
    path, root = make_coco_json(tmp, num_images=6, img_hw=BIG_HW)
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    return tmp


def trainer_cfg(get_cfg, out):
    return tiny_cfg(get_cfg, **{
        "MODEL.RESNETS.NORM": "SyncBN", "TPU.MAX_GT_PER_IMAGE": 10,
        "INPUT.MIN_SIZE_TRAIN": (BIG_HW[0],), "INPUT.MAX_SIZE_TRAIN": BIG_HW[1],
        "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (), "DATALOADER.NUM_WORKERS": 0,
        "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "OUTPUT_DIR": str(out),
        "TEST.PRECISE_BN.ENABLED": True, "TEST.PRECISE_BN.NUM_ITER": 2})


def test_trainer_precise_bn_matches_the_jax_trainer(synth, tmp_path):
    """``test()`` recomputes the statistics over two batches of the train
    loader (seed 1, unsharded) and keeps them: the next checkpoint carries
    them, and a resumed trainer holds them bit for bit."""
    jt = jtrainer.BaseTrainer(trainer_cfg(jax_get_cfg, tmp_path / "jax"))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jt.state.params, "buffers": jt.state.buffers}))
    pt = ttrainer.BaseTrainer(trainer_cfg(torch_get_cfg, tmp_path / "torch"), device="cpu")
    load_flax_variables(pt.model, variables)
    assert jt.test() == {} and pt.test() == {}
    sd = flax_to_state_dict({"params": variables["params"], "buffers": jax.tree_util.tree_map(
        np.asarray, jax.device_get(jt.state.buffers))})
    state = pt.state()["model"]
    for name, b in pt.model.named_buffers():
        if "running" in name:
            assert ratio(b.numpy(), sd[name].numpy()) <= STAT_RATIO, name
            assert torch.equal(state[name], b)
    assert float(state["head.objectness_norm0.running_var"].mean()) != 1.0
    pt.checkpointer.save("model_0000000", pt.state())
    fresh = ttrainer.BaseTrainer(trainer_cfg(torch_get_cfg, tmp_path / "torch"), device="cpu")
    fresh.resume_or_load(resume=True)
    for name, b in fresh.model.state_dict().items():
        assert torch.equal(b, state[name]), name


def test_checkpoint_round_trip_of_running_statistics(tmp_path):
    """A step moves every running statistic; save, load into a fresh model:
    the state is bit-equal and holds no ``num_batches_tracked``."""
    cfg = tiny_cfg(torch_get_cfg, **{"MODEL.RESNETS.NORM": "BN", "SOLVER.BASE_LR": 1e-3})
    model = torch_build_model(cfg, device="cpu")
    step = make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)
    init = {k: v.clone() for k, v in model.named_buffers()}
    step(train_batch(14))
    moved = [k for k, v in model.named_buffers() if "running" in k and not torch.equal(v, init[k])]
    assert len(moved) == 2 * (20 + 6)
    ckpt = DetectionCheckpointer(str(tmp_path))
    ckpt.save("model_0000001", {"model": model.state_dict(), "iteration": 1})
    fresh = torch_build_model(cfg, device="cpu")
    fresh.load_state_dict(ckpt.load(ckpt.get_checkpoint_file())["model"], strict=True)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert not any("num_batches_tracked" in k for k in model.state_dict())
