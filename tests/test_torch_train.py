"""The PyTorch port's FCOS train step held against the JAX package on the
CPU, in float32: the losses, the target assignment, the centerness targets,
``FCOS.loss`` with its gradients, one optimizer step, the LR schedule, the
parameter groups and the freeze mask, the head's ``train`` flag, and the
fused kernels' autograd through their plain versions (the CUDA kernels'
gradients are checked on a card by ``tests/test_torch_package.py``).

The model case is the JAX package's own dry run: the tiny flagship
(``__graft_entry__._flagship_cfg(tiny=True)``: R-18, fp32, 64x64), weights
from ``init_variables(PRNGKey(0))`` carried over by ``checkpoint/bridge.py``,
and ``_dryrun_multichip_impl``'s batch (seed 0, 2 images, 8 gt boxes).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.engine import make_train_step
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.models.meta_arch import fcos as tfcos
from slenderobjdet_torch.ops import losses as tl
from slenderobjdet_torch.solver import build as tsolver
from slenderobjdet_tpu.models import build_model as jax_build_model
from slenderobjdet_tpu.models.meta_arch import fcos as jfcos
from slenderobjdet_tpu.ops import losses as jl
from slenderobjdet_tpu.solver import build as jsolver

CONFIG = Path(__file__).resolve().parents[1] / "configs/fcos/fcos_R_50_FPN_1x.yaml"
LOSS_RTOL = 1e-5     # elementwise losses: same fp ops, float32
MODEL_LOSS_RTOL = 1e-4   # whole-model losses: conv sum orders differ
GRAD_TOL = 1e-3      # per tensor, max |diff| / max |JAX gradient|
PARAM_RTOL = 1e-5    # parameters after one step, relative
MULTICHIP_R05_LOSS = 5.1998   # MULTICHIP_r05.json, 8 CPU devices


def port_cfg(**overrides):
    """The tiny flagship's config in the port: R-18, fp32."""
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def jax_cfg(**overrides):
    cfg = __graft_entry__._flagship_cfg(tiny=True)
    if overrides:
        cfg.defrost()
        cfg.merge_from_list([x for kv in overrides.items() for x in kv])
        cfg.freeze()
    return cfg


def dryrun_batch():
    """``_dryrun_multichip_impl``'s batch: seed 0, 2 images of 64x64, 8 gt."""
    batch_size, h, w, g = 2, 64, 64, 8
    r = np.random.RandomState(0)
    xy = r.rand(batch_size, g, 2).astype(np.float32) * 30
    wh = r.rand(batch_size, g, 2).astype(np.float32) * 20 + 4
    return {
        "image": r.randint(0, 255, (batch_size, h, w, 3)).astype(np.uint8),
        "gt_boxes": np.concatenate([xy, xy + wh], axis=2),
        "gt_classes": r.randint(0, 80, (batch_size, g)).astype(np.int32),
        "gt_valid": np.ones((batch_size, g), bool),
    }


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, n=(4, 33)):
    rs = np.random.RandomState(seed)
    return rs, rs.randn(*n).astype(np.float32) * 4


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (-1.0, 2.0), (0.5, 1.5)])
def test_sigmoid_focal_loss_matches_jax(alpha, gamma):
    rs, logits = _loss_inputs(1)
    targets = (rs.rand(*logits.shape) > 0.7).astype(np.float32)
    want = jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), alpha, gamma)
    got = tl.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                alpha, gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-7)


def test_optax_sigmoid_ce_matches_jax_and_optax():
    rs, logits = _loss_inputs(2)
    labels = rs.rand(*logits.shape).astype(np.float32)
    got = tl.optax_sigmoid_ce(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jl.optax_sigmoid_ce(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(
        got, np.asarray(optax.sigmoid_binary_cross_entropy(jnp.asarray(logits),
                                                           jnp.asarray(labels))),
        rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("beta", [0.0, 0.1, 1.0])
def test_smooth_l1_loss_matches_jax(beta):
    rs, pred = _loss_inputs(3)
    target = rs.randn(*pred.shape).astype(np.float32)
    want = jl.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target), beta)
    got = tl.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(target), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_ltrb_matches_jax(loss_type):
    rs = np.random.RandomState(4)
    pred = np.exp(rs.randn(64, 4)).astype(np.float32) * 10
    target = rs.uniform(0.5, 40, (64, 4)).astype(np.float32)
    want = jl.iou_loss_ltrb(jnp.asarray(pred), jnp.asarray(target), loss_type)
    got = tl.iou_loss_ltrb(torch.from_numpy(pred), torch.from_numpy(target), loss_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-7)
    with pytest.raises(ValueError):
        tl.iou_loss_ltrb(torch.from_numpy(pred), torch.from_numpy(target), "l2")


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_boxes_matches_jax(loss_type):
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 50, (64, 2))
    pred = np.concatenate([xy, xy + rs.uniform(-2, 30, (64, 2))], 1).astype(np.float32)
    tgt = np.concatenate([xy + rs.uniform(-5, 5, (64, 2)), xy + rs.uniform(1, 30, (64, 2))],
                         1).astype(np.float32)
    want = jl.iou_loss_boxes(jnp.asarray(pred), jnp.asarray(tgt), loss_type)
    got = tl.iou_loss_boxes(torch.from_numpy(pred), torch.from_numpy(tgt), loss_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)


# ------------------------------------------------------------- assignment
def _assign_case():
    """Integer-pixel gt boxes at 128x160 with tied areas (equal-sized boxes
    that overlap, and exact duplicates) and invalid pads."""
    locations, counts = tfcos.fcos_locations((128, 160), (8, 16, 32, 64, 128))
    soi = tfcos.sizes_of_interest(counts)
    rs = np.random.RandomState(6)
    b, g = 3, 12
    xy = rs.randint(0, 120, (b, g, 2))
    wh = rs.randint(4, 80, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], 2).astype(np.float32)
    boxes[:, 1] = boxes[:, 0] + np.array([8, 0, 8, 0], np.float32)  # same area, shifted
    boxes[:, 2] = boxes[:, 0]                                       # exact duplicate
    boxes[0, 5] = [60, 40, 20, 90]                                  # degenerate (x2 < x1)
    classes = rs.randint(0, 80, (b, g)).astype(np.int32)
    valid = rs.rand(b, g) > 0.2
    valid[:, :3] = True
    valid[2] = False                                                # an image with no gt
    return locations, soi, boxes, classes, valid


def test_fcos_assign_matches_jax_exactly():
    locations, soi, boxes, classes, valid = _assign_case()
    labels, reg, ind = jax.vmap(
        lambda bx, c, v: jfcos.fcos_assign_single(jnp.asarray(locations), jnp.asarray(soi),
                                                  bx, c, v, 80))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    t_labels, t_reg, t_ind = tfcos.fcos_assign(
        torch.from_numpy(locations), torch.from_numpy(soi), torch.from_numpy(boxes),
        torch.from_numpy(classes), torch.from_numpy(valid), 80)
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(labels))
    np.testing.assert_array_equal(t_ind.numpy(), np.asarray(ind))
    np.testing.assert_array_equal(t_reg.numpy(), np.asarray(reg))
    pos = np.asarray(labels) < 80
    assert 0 < pos[:2].sum() and not pos[2].any()
    # the tie case: locations inside boxes 0 and 2 (equal areas) go to box 0
    assert (t_ind.numpy()[pos] != 2).all()


def test_centerness_targets_match_jax():
    rs = np.random.RandomState(7)
    reg = rs.uniform(0.1, 60, (2, 300, 4)).astype(np.float32)
    reg[0, :5] = [0.0, 3.0, 2.0, 1.0]
    want = jfcos.compute_centerness_targets(jnp.asarray(reg))
    got = tfcos.compute_centerness_targets(torch.from_numpy(reg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------------------------ model pair
@pytest.fixture(scope="module")
def pair():
    """The tiny flagship in both packages with the same weights, the JAX
    loss, gradients and one optimizer step on the dry-run batch."""
    jcfg = jax_cfg()
    det = jax_build_model(jcfg)
    variables = det.init_variables(jax.random.PRNGKey(0), (64, 64), 2)
    batch = dryrun_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        return det.loss({"params": params, "buffers": variables["buffers"]}, jbatch)

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    tx = jsolver.build_optimizer(jcfg, variables["params"])
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    return {
        "variables": np_vars,
        "batch": batch,
        "total": float(total),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)}),
        "new_params": flax_to_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, new_params)}),
    }


def port_model(variables, **overrides):
    model = torch_build_model(port_cfg(**overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def test_fcos_loss_matches_jax(pair):
    model = port_model(pair["variables"])
    total, metrics = model.loss(pair["batch"])
    total = total.detach()
    assert float(total) == pytest.approx(pair["total"], rel=MODEL_LOSS_RTOL)
    for k in ("cls_loss", "reg_loss", "centerness_loss", "num_pos"):
        assert float(metrics[k].detach()) == pytest.approx(pair["metrics"][k], rel=MODEL_LOSS_RTOL), k
    assert float(metrics["num_pos"]) > 1
    # the single-device loss of the JAX package's 8-device dry run
    assert float(total) == pytest.approx(MULTICHIP_R05_LOSS, abs=1e-4)


def test_fcos_gradients_match_jax(pair):
    """Every trainable tensor's gradient against the JAX gradient carried
    through the bridge; FREEZE_AT=2 leaves the stem and res2 without any."""
    model = port_model(pair["variables"])
    tsolver.build_optimizer(port_cfg(), model)        # applies FREEZE_AT
    total, _ = model.loss(pair["batch"])
    total.backward()
    grads = pair["grads"]
    n_trainable = 0
    for name, p in model.named_parameters():
        if tsolver.frozen(port_cfg(), name):
            assert not p.requires_grad and p.grad is None, name
            continue
        n_trainable += 1
        assert p.grad is not None, name
        assert ratio(p.grad.numpy(), grads[name].numpy()) <= GRAD_TOL, name
    assert n_trainable > 40


def test_one_sgd_step_matches_optax(pair):
    """One ``make_train_step`` update against optax's: the new parameters
    (relative 1e-5) and the update itself."""
    cfg = port_cfg()
    model = port_model(pair["variables"])
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)
    metrics = step(pair["batch"])
    assert float(metrics["total_loss"]) == pytest.approx(pair["total"], rel=MODEL_LOSS_RTOL)
    for name, p in model.named_parameters():
        want = pair["new_params"][name].numpy()
        if tsolver.frozen(cfg, name):
            np.testing.assert_array_equal(p.detach().numpy(), old[name].numpy())
            continue
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(want).max())
        # the update itself, to 1% of its size plus the float32 spacing of
        # the parameters it was added to
        delta = (p.detach() - old[name]).numpy()
        want_delta = want - old[name].numpy()
        ulp = np.spacing(np.abs(old[name].numpy()).max())
        np.testing.assert_allclose(delta, want_delta, rtol=0,
                                   atol=1e-2 * np.abs(want_delta).max() + 2 * ulp)


@pytest.mark.parametrize("method,iters", [("linear", 1000), ("constant", 1000),
                                          ("linear", 0)])
def test_lr_schedule_matches_jax(method, iters):
    over = {"SOLVER.WARMUP_METHOD": method, "SOLVER.WARMUP_ITERS": iters}
    want = jsolver.lr_schedule(jax_cfg(**over))
    got = tsolver.lr_schedule(port_cfg(**over))
    for step in (0, 1, 999, 1000, 60000, 80000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step


def _jax_tree_as_state_dict(tree, codes):
    """A tree of labels as the bridge names them: each leaf a constant
    array of its code."""
    params = jax_build_model(jax_cfg()).init_variables(jax.random.PRNGKey(0))["params"]
    arrays = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                    tree, params)
    return {k: int(v.reshape(-1)[0]) for k, v in flax_to_state_dict({"params": arrays}).items()}


def test_param_groups_and_freeze_mask_match_jax():
    params = jax_build_model(jax_cfg()).init_variables(jax.random.PRNGKey(0))["params"]
    codes = {"regular": 0, "norm": 1, "bias": 2}
    want_labels = _jax_tree_as_state_dict(jsolver._param_labels(params, None), codes)
    want_mask = _jax_tree_as_state_dict(jsolver._freeze_mask(jax_cfg(), params),
                                        {True: 1, False: 0})
    model = torch_build_model(port_cfg(), device="cpu")
    got = tsolver.param_labels(model)
    assert {k: codes[v] for k, v in got.items()} == want_labels
    assert set(got.values()) == {"regular", "norm", "bias"}
    cfg = port_cfg()
    assert {n: int(not tsolver.frozen(cfg, n)) for n in got} == want_mask
    opt = tsolver.build_optimizer(cfg, model)
    by_label = {g["label"]: g for g in opt.param_groups}
    assert by_label["regular"]["weight_decay"] == cfg.SOLVER.WEIGHT_DECAY
    assert by_label["norm"]["weight_decay"] == cfg.SOLVER.WEIGHT_DECAY_NORM
    assert by_label["bias"]["weight_decay"] == cfg.SOLVER.WEIGHT_DECAY_BIAS
    assert sum(len(g["params"]) for g in opt.param_groups) == sum(want_mask.values())


@pytest.mark.parametrize("overrides", [
    {"SOLVER.OPTIM": "ADAM", "SOLVER.BIAS_LR_FACTOR": 2.0},
    {"SOLVER.OPTIM": "ADAMW", "SOLVER.WEIGHT_DECAY_NORM": 0.01},
    {"SOLVER.NESTEROV": True, "SOLVER.CLIP_GRADIENTS.ENABLED": True,
     "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "value", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.01},
    {"SOLVER.CLIP_GRADIENTS.ENABLED": True, "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "norm",
     "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.5, "SOLVER.BIAS_LR_FACTOR": 2.0},
])
def test_two_optimizer_steps_match_optax(overrides):
    """Two updates from the same random gradients on a small FCOS head, for
    the options the flagship leaves at default: ADAM, ADAMW, Nesterov,
    clipping by value and by global norm, the bias LR factor."""
    over = {"SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.1, **overrides}
    jcfg, cfg = jax_cfg(**over), port_cfg(**over)
    head = tfcos.FCOSHead(32, num_classes=3, num_levels=2, num_convs=1)
    params = {k: v.detach().numpy().copy() for k, v in head.named_parameters()}
    rs = np.random.RandomState(8)
    grads = [{k: np.asarray(rs.randn(*v.shape), np.float32) for k, v in params.items()}
             for _ in range(2)]

    def tree(d):    # {"module.leaf": a} -> {"module": {"leaf": a}}, as Flax nests
        out = {}
        for k, v in d.items():
            mod, leaf = k.split(".")
            out.setdefault(mod, {})[leaf] = jnp.asarray(v)
        return out

    jp = tree(params)
    tx = jsolver.build_optimizer(jcfg, jp)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(tree(g), state, jp)
        jp = optax.apply_updates(jp, upd)

    opt = tsolver.build_optimizer(cfg, head)
    schedule = tsolver.lr_schedule(cfg)
    for i, g in enumerate(grads):
        for k, p in head.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        tsolver.clip_gradients(cfg, list(head.parameters()))
        for group in opt.param_groups:
            group["lr"] = schedule(i) * group["lr_factor"]
        opt.step()
    for k, p in head.named_parameters():
        mod, leaf = k.split(".")
        delta = p.detach().numpy() - params[k]
        assert ratio(delta, np.asarray(jp[mod][leaf]) - params[k]) <= 1e-4, k


def test_adagrad_and_unported_variants_raise():
    model = torch_build_model(port_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="ADAGRAD"):
        tsolver.build_optimizer(port_cfg(**{"SOLVER.OPTIM": "ADAGRAD"}), model)
    with pytest.raises(NotImplementedError, match="use_centerness"):
        tfcos.FCOS(port_cfg(), use_centerness=False)
    model.topk_per_gt = 5
    with pytest.raises(NotImplementedError):
        model.loss(dryrun_batch())


def test_fcos_loss_with_norm_reg_targets_and_giou_matches_jax(pair):
    """NORM_REG_TARGETS (head in stride units when training, targets
    divided by the stride) and the GIoU loss, on the same weights."""
    over = {"MODEL.FCOS.NORM_REG_TARGETS": True, "MODEL.FCOS.IOU_LOSS_TYPE": "giou"}
    det = jax_build_model(jax_cfg(**over))
    jvars = jax.tree_util.tree_map(jnp.asarray, pair["variables"])
    total, metrics = jax.jit(det.loss)(
        jvars, {k: jnp.asarray(v) for k, v in pair["batch"].items()})
    model = port_model(pair["variables"], **over)
    t_total, t_metrics = model.loss(pair["batch"])
    assert float(t_total) == pytest.approx(float(total), rel=MODEL_LOSS_RTOL)
    for k in ("cls_loss", "reg_loss", "centerness_loss"):
        assert float(t_metrics[k]) == pytest.approx(float(metrics[k]), rel=MODEL_LOSS_RTOL)


def test_head_train_flag_matches_jax():
    """With NORM_REG_TARGETS the head's regression is relu(scale * x) when
    training and that times the stride at inference, in both packages."""
    from slenderobjdet_tpu.models.meta_arch.fcos import FCOSHead as JHead

    rs = np.random.RandomState(12)
    feats = [rs.randn(2, s, s + 2, 32).astype(np.float32) for s in (8, 4)]
    kw = dict(num_classes=5, norm_reg_targets=True, strides=(8, 16))
    head = JHead(**kw)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        head.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats]))
    params["params"]["scale1"]["scale"] = np.float32(1.5)
    port = tfcos.FCOSHead(32, num_levels=2, **kw)
    load_flax_variables(port, params)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    for train in (True, False):
        want = head.apply(params, [jnp.asarray(f) for f in feats], train=train)
        with torch.no_grad():
            got = port(tf, train=train)
        for g, w in zip(got[1], want[1]):
            assert ratio(g.numpy(), w) <= 1e-5
    with torch.no_grad():
        ratio_px = port(tf)[1][1] / port(tf, train=True)[1][1]
    assert torch.allclose(ratio_px[torch.isfinite(ratio_px)], torch.tensor(16.0))


# ------------------------------------------------------ fused autograd
def _block_args(rs, cin, cm, cout, proj, dt):
    def t(*shape, s=0.2):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * s)

    args = [torch.relu(t(2, 9, 11, cin, s=1.0)).to(dt), t(cin, cm), t(cm, s=0.1),
            t(3, 3, cm, cm, s=0.1), t(cm, s=0.1), t(cm, cout), t(cout, s=0.1)]
    args += [t(cin, cout), t(cout, s=0.1)] if proj else [None, None]
    return args


@pytest.mark.parametrize("proj", [False, True])
def test_fused_bottleneck_autograd_equals_plain_on_cpu(proj):
    from slenderobjdet_torch.ops.fused_bottleneck import (fused_bottleneck,
                                                          reference_bottleneck)

    rs = np.random.RandomState(9)
    args = _block_args(rs, 16, 8, 16 if not proj else 24, proj, torch.float32)
    g = torch.tensor(rs.randn(2, 9, 11, args[5].shape[1]).astype(np.float32))
    grads = []
    for fn in (fused_bottleneck, reference_bottleneck):
        leaves = [None if a is None else a.clone().requires_grad_() for a in args]
        fn(*leaves).backward(g)
        grads.append([None if a is None else a.grad for a in leaves])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_fused_stem_autograd_equals_plain_on_cpu():
    from slenderobjdet_torch.ops.fused_stem import fused_stem, reference_stem

    rs = np.random.RandomState(10)
    x = torch.tensor(rs.randn(2, 16, 24, 3).astype(np.float32) * 20)
    w = torch.tensor(rs.randn(7, 7, 3, 8).astype(np.float32) * 0.1)
    scale = torch.tensor(rs.uniform(0.5, 1.5, 8).astype(np.float32))
    bias = torch.tensor(rs.randn(8).astype(np.float32) * 0.1)
    grads = []
    for fn in (fused_stem, reference_stem):
        wl, bl = w.clone().requires_grad_(), bias.clone().requires_grad_()
        fn(x, wl, scale, bl).square().sum().backward()
        grads.append((wl.grad, bl.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    assert grads[0][0].abs().max() > 0


def test_fused_flags_train_on_cpu_like_unfused(pair):
    """FUSED_STEM/FUSED_BLOCKS on an R-50-structured narrow model: on the CPU
    the Functions take the plain versions, and the loss and the gradients
    of res3-res5 equal the unfused model's to float rounding."""
    base = {"MODEL.RESNETS.DEPTH": 50, "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
            "MODEL.RESNETS.RES2_OUT_CHANNELS": 32, "MODEL.RESNETS.STEM_OUT_CHANNELS": 16,
            "MODEL.FPN.OUT_CHANNELS": 32}
    models = []
    for fused in (False, True):
        cfg = port_cfg(**base, **{"MODEL.RESNETS.FUSED_STEM": fused,
                                  "MODEL.RESNETS.FUSED_BLOCKS": fused})
        m = torch_build_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(4))
        tsolver.build_optimizer(cfg, m)
        total, _ = m.loss(pair["batch"])
        total.backward()
        models.append((float(total), dict(m.named_parameters())))
    (t0, p0), (t1, p1) = models
    assert t1 == pytest.approx(t0, rel=1e-5)
    checked = 0
    for name, p in p0.items():
        if p.grad is None:
            assert p1[name].grad is None
            continue
        assert ratio(p1[name].grad.numpy(), p.grad.numpy()) <= 1e-4, name
        checked += "res4_2.conv2" in name or "res5_1.conv3" in name
    assert checked == 2
