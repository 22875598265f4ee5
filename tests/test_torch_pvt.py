"""The port's PVT trunk (``slenderobjdet_torch/models/backbones/pvt.py``) and
RetinaNet on it held against the JAX package on the CPU, in float32:

- the position-embedding resize against ``jax.image.resize(..., "bilinear")``
  at shrinking and growing grids (1e-6 of the largest value);
- ``SRAttention`` at spatial reduction 1 and 2, and ``PVT`` at narrow widths
  (8/16/32/64, one block a stage) at 64 x 64 and 64 x 96, where stage 4's
  grid shrinks the 7 x 7 embedding: every stage's output (1e-5 of the
  largest value) and the gradients of a weighted sum of them with respect
  to the input and to ``pos_embed{i}`` (1e-4), against ``jax.grad``;
- RetinaNet on ``build_retinanet_pvt_fpn_backbone`` (PVT "tiny": full
  widths, 2 blocks a stage) at 64 x 64: head outputs (1e-4), each loss term
  (1e-4), every gradient (1e-3), predict slot for slot, and one
  ``TrainStep`` against optax's update of the same gradients, at the
  default weight decay and at one whose norm / regular split shows in a
  single step;
- ``param_labels`` against JAX's ``_param_labels`` leaf for leaf;
- ``TPU.INT8_PREDICT``: the convs taken over, site by site, against JAX's
  interceptor; and the ``torch.export`` artifact of the detector, reloaded
  equal to the live model.

Weights are drawn in numpy on the JAX tree's shapes and carried to the port
by ``checkpoint/bridge.py``; every input comes from a numpy seed inside its
test. ``tests/test_torch_pvtv2.py``, ``tests/test_torch_vt_fpn.py`` and
``tests/test_torch_pvt_import.py`` import the harness below.
"""

import copy
import os
import re
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch import serving  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.backbones import pvt as tpvt  # noqa: E402
from slenderobjdet_torch.models.layers import LayerNorm  # noqa: E402
from slenderobjdet_torch.ops import quant as tq  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.backbones import pvt as jpvt  # noqa: E402
from slenderobjdet_tpu.ops import quant as jq  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402

RETINA_YAML = os.path.join(os.path.dirname(__file__), "..", "configs/retina/retinanet_R_50_FPN_1x.yaml")
RESIZE_TOL = 1e-6        # max |diff| / max |value|
MODULE_TOL = 1e-5        # a module's outputs
MODULE_GRAD_TOL = 1e-4   # its gradients, per tensor
MODEL_TOL = 1e-4         # a whole detector's head outputs and losses
MODEL_GRAD_TOL = 1e-3    # its gradients, per tensor
PARAM_RTOL = 1e-5        # parameters after one step, relative (tests/test_torch_train.py)
NARROW = dict(dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
              mlp_ratios=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1))
PVT_FAMILIES = {
    "pvt": {"MODEL.BACKBONE.NAME": "build_retinanet_pvt_fpn_backbone"},
    "pvtv2": {"MODEL.BACKBONE.NAME": "build_retinanet_pvtv2_fpn_backbone"},
}
PVT_OVERRIDES = {"MODEL.PVT.DEPTH": "tiny", "MODEL.FPN.IN_FEATURES": ["pvt2", "pvt3", "pvt4"]}
WEIGHT_DECAYS = (1e-4, 0.1)   # the default; one at which a LayerNorm's label shows in one step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def nchw(a):
    """A JAX NHWC array as the port's NCHW layout."""
    return np.asarray(a).transpose(0, 3, 1, 2)


# ------------------------------------------------------------ the weights
def draw_tree(shapes, seed, head_std=None):
    """numpy float32 leaves on a tree of shapes: kernels normal with std
    1/sqrt(fan in) (the head's ``head_std``, when given), LayerNorm and
    GroupNorm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1) (the head's 0),
    ``pos_embed{i}`` 0.5 N(0, 1), FrozenBN scales in [0.75, 1.25] and biases
    0.05 N(0, 1): every part of the network away from a special value."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        head = head_std is not None and "head" in keys
        if keys[0] == "buffers":
            return (rs.uniform(0.75, 1.25, shape) if name == "scale"
                    else rs.randn(*shape) * 0.05).astype(np.float32)
        if name == "kernel":
            fan_in = shape[0] if len(shape) == 3 and keys[-2] != "out" else np.prod(shape[:-1])
            return (rs.randn(*shape) * (head_std if head else 1 / np.sqrt(fan_in))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name.startswith("pos_embed"):
            return (0.5 * rs.randn(*shape)).astype(np.float32)
        return (np.zeros(shape) if head else 0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def module_pair(jax_module, torch_module, x, seed):
    """The Flax module's variables drawn on its shapes, the same carried into
    the torch module (its names are the Flax tree's, renamed by the bridge)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), x)
    variables = draw_tree(shapes, seed)
    sd = flax_to_state_dict(variables)
    assert sorted(sd) == sorted(torch_module.state_dict())
    torch_module.load_state_dict(sd)
    return variables


def weighted_sum(outputs, seed):
    """A scalar of every output: each weighted by a fixed numpy draw."""
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*np.shape(v)).astype(np.float32) for k, v in sorted(outputs.items())}


# ------------------------------------------------------------ resize
@pytest.mark.parametrize("src,dst", [((7, 7), (2, 2)), ((7, 7), (3, 5)), ((7, 7), (28, 44)),
                                     ((56, 56), (7, 7))])
def test_pos_embed_resize_matches_jax_image_resize(src, dst):
    """``jax.image.resize`` antialiases where the grid shrinks: a plain
    bilinear resize is 1.1-1.5 away there."""
    grid = np.random.RandomState(1).randn(1, *src, 16).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, *dst, 16), "bilinear"))
    got = tpvt.resize_pos_embed(torch.from_numpy(grid), dst).numpy()
    assert got.shape == want.shape
    assert ratio(got, want) <= RESIZE_TOL


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("sr", [1, 2])
def test_sr_attention_matches_jax(sr):
    """At a 7 x 11 grid Flax's "SAME" pads the 2 x 2 / 2 reduction by one
    row and one column at the end."""
    hw, dim, heads = (7, 11), 32, 4
    x = np.random.RandomState(2 + sr).randn(2, hw[0] * hw[1], dim).astype(np.float32)
    jmod = jpvt.SRAttention(dim, heads, sr)
    tmod = tpvt.SRAttention(dim, heads, sr)
    shapes = jax.eval_shape(lambda k, v: jmod.init(k, v, hw), jax.random.PRNGKey(0), x)
    variables = draw_tree(shapes, seed=4)
    tmod.load_state_dict(flax_to_state_dict(variables))
    want = jax.jit(lambda v, a: jmod.apply(v, a, hw))(variables, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), hw)
    assert ratio(got.numpy(), want) <= MODULE_TOL


def check_trunk(v2, hw):
    """Every stage's output, and the gradients of a weighted sum of them with
    respect to the input and (v1) to each stage's 7 x 7 position embedding,
    whose resize shrinks at stage 4 (2 x 2 and 2 x 3 grids)."""
    x = np.random.RandomState(5).randn(2, *hw, 3).astype(np.float32)
    jmod = (jpvt.PVTv2 if v2 else jpvt.PVT)(**NARROW)
    tmod = tpvt.PVT(**NARROW, v2=v2)
    variables = module_pair(jmod, tmod, x, seed=6)
    shapes = jax.eval_shape(lambda v, a: jmod.apply(v, a), variables, x)
    weights = weighted_sum(shapes, seed=7)

    def objective(params, a):
        out = jmod.apply({"params": params}, a)
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), (g_params, g_x) = jax.jit(jax.value_and_grad(objective, argnums=(0, 1),
                                                            has_aux=True))(variables["params"], x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = tmod(xt)
    assert sorted(got) == sorted(want) == ["pvt1", "pvt2", "pvt3", "pvt4"]
    for k in want:
        assert ratio(got[k].detach().numpy(), nchw(want[k])) <= MODULE_TOL, k
    sum(torch.sum(got[k] * torch.from_numpy(nchw(w))) for k, w in weights.items()).backward()
    assert ratio(xt.grad.permute(0, 2, 3, 1).numpy(), g_x) <= MODULE_GRAD_TOL
    grads = flax_to_state_dict({"params": g_params})
    names = [n for n in grads if n.startswith("pos_embed")]
    assert len(names) == (0 if v2 else 4)
    params = dict(tmod.named_parameters())
    for name in names + ["patch_embed1.weight", "stage4_block0.attn.kv.weight"]:
        assert ratio(params[name].grad.numpy(), grads[name].numpy()) <= MODULE_GRAD_TOL, name


# ------------------------------------------------------------ detectors
def detector_cfg(get_cfg, overrides, **more):
    cfg = get_cfg()
    cfg.merge_from_file(RETINA_YAML)
    opts = {"TPU.COMPUTE_DTYPE": "float32", "TPU.APPROX_TOPK": False, **overrides, **more}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def train_batch(seed, batch=2, g=8, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    xy = rs.randint(0, hw[1] - 16, (batch, g, 2))
    boxes = np.concatenate([xy, xy + rs.randint(8, 40, (batch, g, 2))], -1).astype(np.float32)
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": np.minimum(boxes, hw[1]).astype(np.float32),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": np.arange(g)[None] < np.array([[5], [8]])[:batch]}


def predict_batch(seed, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, *hw, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([hw, [51, 51]], np.float32)}


def detector_case(overrides, seed, tenth=()):
    """RetinaNet on a trunk in both packages with the same drawn weights, and
    the JAX side's numbers in ONE compiled program: the head outputs on a
    predict batch, the loss, its metrics and gradients on a train batch,
    predict, and optax's new parameters after one step for each of
    WEIGHT_DECAYS. The classifier is drawn at std 0.01 with its bias chosen on
    the port's own logits so that about one score in 1,000 passes
    SCORE_THRESH_TEST: a few dozen detections an image. Kernels under a
    module named in ``tenth`` are drawn at a tenth of their deviation."""
    jcfg = detector_cfg(jax_get_cfg, overrides)
    det = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda k: det.init_variables(k, (64, 64), batch_size=1),
                            jax.random.PRNGKey(0))
    variables = draw_tree(shapes, seed, head_std=0.01)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        if any(getattr(p, "key", "").startswith(tuple(tenth)) for p in path):
            leaf *= 0.1
    model = torch_build_model(detector_cfg(torch_get_cfg, overrides), device="cpu")
    load_flax_variables(model, variables)
    pbatch, tbatch = predict_batch(seed + 1), train_batch(seed + 2)
    with torch.no_grad():
        logits = torch.cat(model(torch.from_numpy(pbatch["image"]))[0], 1).flatten()
    bias = float(np.log(0.05 / 0.95)) - float(torch.quantile(logits, 1 - 1 / 1000))
    variables["params"]["head"]["cls_score"]["bias"][:] = bias
    load_flax_variables(model, variables)

    txs = {wd: jsolver.build_optimizer(detector_cfg(jax_get_cfg, overrides,
                                                    **{"SOLVER.WEIGHT_DECAY": wd}),
                                       variables["params"]) for wd in WEIGHT_DECAYS}
    rest = {k: v for k, v in variables.items() if k != "params"}

    def reference(params, tb, pb):
        def loss_fn(p):
            return det.loss({"params": p, **rest}, tb)

        (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        full = {"params": params, **rest}
        new = {wd: optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])
               for wd, tx in txs.items()}
        return (total, metrics, grads, det.module.apply(full, pb["image"]),
                det.predict(full, pb), new)

    out = jax.jit(reference)(variables["params"], tbatch, pbatch)
    out = jax.tree_util.tree_map(np.asarray, out)
    total, metrics, grads, heads, dets, new = out
    return {"variables": variables, "model": model, "overrides": overrides,
            "predict_batch": pbatch, "train_batch": tbatch, "total": float(total),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_state_dict({"params": grads}), "heads": heads, "dets": dets,
            "new_params": {wd: flax_to_state_dict({"params": p}) for wd, p in new.items()}}


def check_heads(case):
    with torch.no_grad():
        logits, regs = case["model"](torch.from_numpy(case["predict_batch"]["image"]))
    want_logits, want_regs = case["heads"]
    assert len(logits) == len(want_logits) == 5
    for got_l, want_l in ((logits, want_logits), (regs, want_regs)):
        for lvl, (g, w) in enumerate(zip(got_l, want_l)):
            assert tuple(g.shape) == w.shape
            assert ratio(g.numpy(), w) <= MODEL_TOL, lvl


def check_loss_and_gradients(case, family_names, invariant=None):
    """The loss, its terms and every gradient against JAX's. ``invariant``
    (a regex) names the parameters whose gradient is zero in exact
    arithmetic (a bias added to every score that one softmax normalises):
    both sides' rounding noise is held under 1e-6 of the model's largest
    gradient instead."""
    model = case["model"]
    cfg = detector_cfg(torch_get_cfg, case["overrides"])
    tsolver.build_optimizer(cfg, model)           # applies FREEZE_AT
    model.zero_grad(set_to_none=True)
    total, metrics = model.loss(case["train_batch"])
    assert float(total.detach()) == pytest.approx(case["total"], rel=MODEL_TOL)
    assert sorted(metrics) == sorted(case["metrics"]) == ["loss_box_reg", "loss_cls", "num_pos"]
    for k, v in case["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=MODEL_TOL), k
    assert float(metrics["num_pos"]) > 1
    total.backward()
    checked = set()
    floor = 1e-6 * max(float(np.abs(g.numpy()).max()) for g in case["grads"].values())
    for name, p in model.named_parameters():
        if invariant and re.search(invariant, name):
            assert float(p.grad.abs().max()) <= floor, name
            assert float(np.abs(case["grads"][name].numpy()).max()) <= floor, name
            checked.add(name)
            continue
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        if p.grad is None:      # unused by the loss (pvt1 feeds no FPN level)
            assert not np.any(case["grads"][name].numpy()), name
            continue
        assert ratio(p.grad.numpy(), case["grads"][name].numpy()) <= MODEL_GRAD_TOL, name
        checked.add(name)
    assert set(family_names) <= checked
    model.zero_grad(set_to_none=True)


def check_predict(case):
    want = case["dets"]
    got = case["model"].predict(case["predict_batch"])
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores", "valid"]
    valid = want["valid"]
    per_image = valid.sum(1)
    assert (per_image >= 10).all() and (per_image < 100).all(), per_image
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid],
                               rtol=0, atol=1e-3)


def check_train_step(case, wd):
    """One ``make_train_step`` update (SGD, momentum, the yaml's BASE_LR) against
    optax's: the new parameters (relative 1e-5) and the update itself (1e-2 of
    its largest entry plus two float32 spacings of the parameter)."""
    cfg = detector_cfg(torch_get_cfg, case["overrides"], **{"SOLVER.WEIGHT_DECAY": wd})
    model = copy.deepcopy(case["model"])
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)
    metrics = step(case["train_batch"])
    assert float(metrics["total_loss"]) == pytest.approx(case["total"], rel=MODEL_TOL)
    want_params = case["new_params"][wd]
    for name, p in model.named_parameters():
        want = want_params[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(want).max(), err_msg=name)
        delta, want_delta = (p.detach() - old[name]).numpy(), want - old[name].numpy()
        ulp = np.spacing(np.abs(old[name].numpy()).max())
        np.testing.assert_allclose(delta, want_delta, rtol=0,
                                   atol=1e-2 * np.abs(want_delta).max() + 2 * ulp, err_msg=name)


def label_codes(params):
    codes = {"regular": 0, "norm": 1, "bias": 2}
    tree = jsolver._param_labels(params, None)
    arrays = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                    tree, params)
    want = {k: int(v.reshape(-1)[0]) for k, v in flax_to_state_dict({"params": arrays}).items()}
    return codes, want


def check_labels(case):
    codes, want = label_codes(case["variables"]["params"])
    got = tsolver.param_labels(case["model"])
    assert {k: codes[v] for k, v in got.items()} == want
    ln = [f"{n}.weight" for n, m in case["model"].named_modules() if isinstance(m, LayerNorm)]
    assert ln and all(got[k] == "norm" for k in ln)


# ------------------------------------------------------------ int8, serving
def jax_sites(cfg, hw=(64, 64)):
    """Every nn.Conv call of JAX's forward (traced abstractly):
    (path, eligible, static_eligible)."""
    det = jax_build_model(cfg)
    sites = []

    def record(next_fn, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and type(mod) is fnn.Conv:
            x = args[0]
            sites.append((jq.module_path(mod), jq.eligible(mod, x), jq.static_eligible(mod, x)))
        return next_fn(*args, **kwargs)

    def forward(key, images):
        variables = det.init_variables(key, hw, batch_size=1)
        with fnn.intercept_methods(record):
            return det.module.apply(variables, images)

    jax.eval_shape(forward, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, *hw, 3), jnp.uint8))
    return sorted(sites)


def port_sites(model, hw=(64, 64)):
    sites = []

    def record(mod, x):
        sites.append((tq.module_path(mod), tq.eligible(mod, x), tq.static_eligible(mod, x)))

    with torch.no_grad(), tq._intercepting(record):
        model(torch.zeros(1, *hw, 3, dtype=torch.uint8))
    return sorted(sites)


def check_int8_sites(case, trunk_sites):
    """The convs ``TPU.INT8_PREDICT`` takes over, site by site, against JAX's
    interceptor; under the scope the head's outputs are finite and move."""
    model = case["model"]
    got = port_sites(model)
    assert got == jax_sites(detector_cfg(jax_get_cfg, case["overrides"]))
    assert {s for s, e, _ in got if e} < {s for s, _, e in got if e}
    assert all(any(t in s for s, _, _ in got) for t in trunk_sites)
    images = torch.from_numpy(case["predict_batch"]["image"])
    with torch.no_grad():
        fp = torch.cat(model(images)[0], 1)
        with tq.int8_predict_scope(True):
            q = torch.cat(model(images)[0], 1)
    assert torch.isfinite(q).all() and not torch.equal(q, fp)


# ------------------------------------------------------------ PVT v1
PVT_CHECKED = ["backbone.bottom_up.stage2_block1.attn.sr.weight",
               "backbone.bottom_up.stage4_block1.fc1.weight", "backbone.bottom_up.embed_norm3.weight",
               "backbone.fpn_lateral0.weight", "backbone.top_p6.weight", "head.cls_score.bias"]
PVT_SITES = ["bottom_up/patch_embed2", "bottom_up/stage1_block0/attn/sr"]


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_pvt_trunk_and_gradients_match_jax(hw):
    check_trunk(False, hw)


@pytest.fixture(scope="module")
def case():
    return detector_case({**PVT_FAMILIES["pvt"], **PVT_OVERRIDES}, seed=20)


def test_pvt_retinanet_heads_match_jax(case):
    check_heads(case)


def test_pvt_retinanet_loss_and_gradients_match_jax(case):
    check_loss_and_gradients(case, PVT_CHECKED + ["backbone.bottom_up.pos_embed4"])


def test_pvt_retinanet_predict_matches_jax(case):
    check_predict(case)


@pytest.mark.parametrize("wd", WEIGHT_DECAYS)
def test_pvt_retinanet_train_step_matches_jax(case, wd):
    check_train_step(case, wd)


def test_pvt_param_labels_equal_jax_leaf_for_leaf(case):
    check_labels(case)


def test_pvt_int8_sites_match_jax_site_by_site(case):
    check_int8_sites(case, PVT_SITES)


def test_pvt_export_reloads_equal_to_the_live_model(case, tmp_path):
    """The ``torch.export`` artifact of RetinaNet on PVT (the position
    embeddings' resize and the NMS operator in the program) at B = 2,
    64 x 64, reloaded: its detections equal the live model's bit for bit."""
    model = case["model"]
    path = str(tmp_path / "pvt")
    serving.export_detector(model, path, batch_size=2, image_hw=(64, 64))
    got = serving.load_detector(path)(case["predict_batch"])
    want = model.predict(case["predict_batch"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert int(want["valid"].sum()) > 0
