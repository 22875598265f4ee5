"""The PyTorch port's proposal networks held against the JAX package on the
CPU, in float32 at the tiny size (R-18, 64 x 64 images; the FPN and the
heads keep their 256 channels: at 64 a GroupNorm group of P7's single cell
holds 2 values and the norm amplifies float32 rounding 200-fold in both
packages):

- for ``RepPointsGenerator`` (BatchNorm head), ``PointsProposalGenerator``
  and ``ProposalNetworkWithMasks``, with weights through the bridge
  (FrozenBN, BatchNorm and GroupNorm drawn away from identity): head
  outputs within 1e-4 of a level's largest value with running and with
  batch statistics, each loss
  term within 1e-4 relative, the BatchNorm running statistics a loss leaves
  within 1e-5 of their largest value, every trainable gradient within 1e-3 of the largest, and
  ``predict`` slot for slot against ``jax.jit(det.predict)`` (boxes within
  1e-3 px, scores 1e-5, ``valid`` equal) on integer-pixel gt;
- the RPG's point and inside assignments exactly, its OHEM with no
  positive finite, ``likelihood_loss`` and the chunked size map
  (``_sizes_from_boxes``) exactly;
- both registry names and the dispatcher, and ``train_net_torch.main`` on
  the RPG: train, ``--resume`` bit-equal with the BatchNorm statistics,
  evaluate.

Every input comes from a numpy seed inside its test; each JAX detector is
initialised once a module.
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
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.layers import BatchNorm, batch_statistics  # noqa: E402
from slenderobjdet_torch.models.meta_arch.proposal_network import (  # noqa: E402
    ProposalNetworkWithMasks)
from slenderobjdet_torch.models.proposal_generator import ppg as tppg  # noqa: E402
from slenderobjdet_torch.models.proposal_generator.rpg import RepPointsGenerator  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.proposal_generator import ppg as jppg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FCOS_YAML = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
GENERATORS = ("RepPointsGenerator", "PointsProposalGenerator", "ProposalNetworkWithMasks")
HEAD_RATIO = 1e-4        # per level, max |diff| / max |JAX value|
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3          # per tensor, max |diff| / max |JAX gradient|
# running statistics a model's forward leaves, per tensor over its largest
# value: the activations they average agree to float32 rounding (~1e-6)
STAT_RATIO = 1e-5
HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: under the tier's six
    workers on one shared CPU, eight threads a process make the port's many
    small operations wait on each other (``main`` 93 s against 2 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg, generator="RepPointsGenerator", arch="ProposalNetwork", **overrides):
    """The flagship yaml with the proposal-network overrides, R-18, fp32.
    ``ProposalNetworkWithMasks`` is built through any other generator name."""
    cfg = get_cfg()
    cfg.merge_from_file(str(FCOS_YAML))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = ("RPN" if generator == "ProposalNetworkWithMasks"
                                         else generator)
    cfg.MODEL.RPN.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def int_boxes(rs, shape, span, lo, hi):
    xy = rs.randint(0, span, (*shape, 2))
    return np.concatenate([xy, xy + rs.randint(lo, hi, (*shape, 2))], -1).astype(np.float32)


def train_batch(seed, batch=2, g=6, hw=HW):
    """uint8 images and integer-pixel gt boxes of 6-40 pixels, the last two
    rows padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": int_boxes(rs, (batch, g), hw[1] - 20, 6, 40),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


def predict_batch(seed, hw=(64, 96)):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, *hw, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([hw, [51, 76]], np.float32)}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


# head output convs drawn so that scores spread over several units of logit
# and boxes span pixels: (kernel std, bias) by generator and conv
HEAD_DRAW = {
    "RepPointsGenerator": {"objectness_out": (0.007, 0.0), "deltas_out": (0.2, 0.0)},
    "PointsProposalGenerator": {"in_object_logits": (0.002, 0.0), "offsets": (2e-4, 0.0)},
    "ProposalNetworkWithMasks": {"objectness": (0.05, -1.0), "deltas": (0.03, 2.0)},
}


def randomize(variables, generator, seed):
    """numpy copy of a Flax tree with every norm away from identity (FrozenBN
    scale and bias; BatchNorm scale, bias, mean and var; GroupNorm scale and
    bias) and the head's output convs drawn by HEAD_DRAW."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)

    def walk(node, params):
        for k, v in node.items():
            if not isinstance(v, dict):
                continue
            if params and ("GroupNorm_0" == k or (k.startswith("objectness_norm")
                                                  or k.startswith("deltas_norm"))):
                v["scale"] = rs.uniform(0.8, 1.2, v["scale"].shape).astype(np.float32)
                v["bias"] = (rs.randn(*v["bias"].shape) * 0.1).astype(np.float32)
            elif not params and "scale" in v:
                v["scale"] = rs.uniform(0.75, 1.25, v["scale"].shape).astype(np.float32)
                v["bias"] = (rs.randn(*v["bias"].shape) * 0.05).astype(np.float32)
            elif not params and "mean" in v:
                v["mean"] = (rs.randn(*v["mean"].shape) * 0.1).astype(np.float32)
                v["var"] = rs.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            else:
                walk(v, params)

    walk(out["params"], True)
    walk(out["buffers"], False)
    head = out["params"]["head"]
    for name, (std, bias) in HEAD_DRAW[generator].items():
        head[name]["kernel"] = (rs.randn(*head[name]["kernel"].shape) * std).astype(np.float32)
        head[name]["bias"][:] = bias
    return out


@pytest.fixture(scope="module")
def setups():
    """Per generator: the JAX detector, its randomised tree (numpy) and the
    jitted eval apply."""
    out = {}
    for i, name in enumerate(GENERATORS):
        det = jax_build_model(tiny_cfg(jax_get_cfg, name))
        variables = randomize(det.init_variables(jax.random.PRNGKey(i)), name, 50 + i)
        out[name] = {"det": det, "variables": variables}
    return out


def port_model(generator, variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, generator, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def assert_buffers_close(model, params, want_buffers, tol=STAT_RATIO):
    """Every leaf of a JAX buffers tree against the port model's buffers
    (the parameters tell the bridge a basic block from a bottleneck)."""
    want = flax_to_state_dict({"params": params, "buffers": want_buffers})
    got = dict(model.named_buffers())
    for k, v in want.items():
        if k in got:
            assert ratio(got[k].numpy(), v.numpy()) <= tol, k
    return want


# ------------------------------------------------------------ registry
def test_registry_dispatches_as_jax():
    assert len(META_ARCHS) == 28
    for arch in ("ProposalNetwork", "ProposalNetworkWithMasks"):
        for generator, cls in (("RepPointsGenerator", RepPointsGenerator),
                               ("PointsProposalGenerator", tppg.PointsProposalGenerator),
                               ("ProposalNetworkWithMasks", ProposalNetworkWithMasks)):
            cfg = tiny_cfg(torch_get_cfg, generator, arch)
            model = torch_build_model(cfg, device="cpu")
            jdet = jax_build_model(tiny_cfg(jax_get_cfg, generator, arch))
            assert type(model) is cls and type(jdet).__name__ == cls.__name__
    model = torch_build_model(tiny_cfg(torch_get_cfg, "ProposalNetworkWithMasks",
                                       **{"TPU.INT8_PREDICT": True}), device="cpu")
    assert type(model) is ProposalNetworkWithMasks and model.int8_predict


def test_bridge_carries_each_tree(setups):
    for name, s in setups.items():
        leaves = jax.tree_util.tree_leaves(s["variables"])
        model = port_model(name, s["variables"])
        assert len(flax_to_state_dict(s["variables"])) == len(leaves) == len(model.state_dict())
    rpg = port_model("RepPointsGenerator", setups["RepPointsGenerator"]["variables"])
    head = setups["RepPointsGenerator"]["variables"]
    np.testing.assert_array_equal(rpg.head.deltas_norm2.running_var.numpy(),
                                  head["buffers"]["head"]["deltas_norm2"]["var"])
    np.testing.assert_array_equal(rpg.head.moment_transfer.detach().numpy(),
                                  head["params"]["head"]["moment_transfer"])
    assert isinstance(rpg.head.objectness_norm0, BatchNorm)
    assert "num_batches_tracked" not in " ".join(rpg.state_dict())


# ------------------------------------------------------------ heads
@pytest.mark.parametrize("name", GENERATORS)
def test_head_outputs_match_jax(setups, name):
    """With running statistics (predict) and with batch statistics (a
    loss's apply, which for the RPG updates the shared BatchNorms level by
    level: the running statistics after the forward are compared too)."""
    s = setups[name]
    det, variables = s["det"], s["variables"]
    model = port_model(name, variables)
    # P7 2 x 2: with batch statistics a 1 x 1 P7 at B = 2 normalises two
    # values a channel, which amplifies float32 rounding (as GroupNorm's
    # two-value groups do at 64 channels)
    images = train_batch(60, hw=(192, 256))["image"]
    jv = tree(variables)
    want_eval = jax.jit(det.module.apply)(jv, jnp.asarray(images))
    with torch.no_grad():
        got_eval = model(torch.from_numpy(images))
    for g_l, w_l in zip(got_eval, want_eval):
        if not isinstance(w_l, list):           # the RPG's moment_transfer
            np.testing.assert_array_equal(g_l.detach().numpy(), np.asarray(w_l))
            continue
        for g, w in zip(g_l, w_l):
            assert tuple(g.shape) == w.shape
            assert ratio(g.numpy(), w) <= HEAD_RATIO
    if name != "RepPointsGenerator":
        return
    want_train, mut = jax.jit(lambda v, x: det.module.apply(v, x, mutable=["buffers"]))(
        jv, jnp.asarray(images))
    with torch.no_grad(), batch_statistics():
        got_train = model(torch.from_numpy(images))
    for g_l, w_l in zip(got_train[:2], want_train[:2]):
        for g, w in zip(g_l, w_l):
            assert ratio(g.numpy(), w) <= HEAD_RATIO
    assert ratio(got_train[0][0].numpy(), got_eval[0][0].numpy()) > 1e-3
    want = assert_buffers_close(model, variables["params"],
                                jax.tree_util.tree_map(np.asarray, mut["buffers"]))
    assert not np.allclose(want["head.objectness_norm0.running_mean"].numpy(),
                           variables["buffers"]["head"]["objectness_norm0"]["mean"])


# ------------------------------------------------------------ losses
@pytest.fixture(scope="module")
def jax_losses(setups):
    """Per generator the JAX loss, metrics, the buffers its apply wrote and
    the gradients on one batch (the PPG's without a size map: the
    box-rasterised fallback)."""
    out = {}
    for name, s in setups.items():
        det, jv = s["det"], tree(s["variables"])
        batch = train_batch(61)

        def loss_fn(params, det=det, jv=jv, batch=batch):
            return det.loss({"params": params, "buffers": jv["buffers"]}, jnp_batch(batch))

        (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"])
        out[name] = {
            "batch": batch, "total": float(total),
            "metrics": {k: float(v) for k, v in metrics.items() if not k.startswith("_")},
            "buffers": jax.tree_util.tree_map(np.asarray, metrics.get("_buffers")),
            "grads": flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})}
    return out


@pytest.mark.parametrize("name", GENERATORS)
def test_loss_terms_and_gradients_match_jax(setups, jax_losses, name):
    want = jax_losses[name]
    cfg = tiny_cfg(torch_get_cfg, name)
    model = port_model(name, setups[name]["variables"])
    tsolver.build_optimizer(cfg, model)               # applies FREEZE_AT
    total, metrics = model.loss(want["batch"])
    assert sorted(metrics) == sorted(want["metrics"])
    assert float(total.detach()) == pytest.approx(want["total"], rel=LOSS_RTOL)
    for k, v in want["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    assert float(metrics["num_pos"]) > 2
    if want["buffers"] is not None:
        # at 64 x 64 and B = 2 the shared BatchNorms normalise P7 by two
        # values a channel, and the next layers' statistics carry the
        # amplified rounding (the head test holds them at 1e-5 on 192 x 256)
        assert_buffers_close(model, setups[name]["variables"]["params"], want["buffers"],
                             HEAD_RATIO)
    total.backward()
    checked = set()
    largest = max(float(g.abs().max()) for g in want["grads"].values())
    for pname, p in model.named_parameters():
        if tsolver.frozen(cfg, pname):
            assert p.grad is None, pname
            continue
        if pname.endswith("_conv0.bias") or pname.endswith("_conv1.bias") \
                or pname.endswith("_conv2.bias"):
            # a bias a BatchNorm follows shifts what the batch mean removes:
            # its gradient is 0 up to rounding in both packages
            assert float(p.grad.abs().max()) <= 1e-6 * largest, pname
            assert float(want["grads"][pname].abs().max()) <= 1e-6 * largest, pname
            continue
        assert ratio(p.grad.numpy(), want["grads"][pname].numpy()) <= GRAD_TOL, pname
        checked.add(pname)
    heads = {"RepPointsGenerator": ("head.objectness_norm0.weight", "head.deltas_norm2.bias",
                                    "head.moment_transfer", "head.deltas_out.weight"),
             "PointsProposalGenerator": ("head.conv.weight", "head.in_object_logits.bias"),
             "ProposalNetworkWithMasks": ("head.gn1.weight", "head.deltas.weight",
                                          "head.objectness.bias")}[name]
    assert set(heads) | {"backbone.bottom_up.res4_0.conv1.weight"} <= checked


def test_ppg_size_map_loss_matches_jax(setups):
    """The PPG's objectness bands from a given size map (B, H, W, 2)."""
    s = setups["PointsProposalGenerator"]
    batch = train_batch(62)
    sm = np.zeros((2, *HW, 2), np.float32)
    sm[0, 10:40, 10:30] = (20.0, 30.0)
    sm[1, 4:60, 20:64] = (50.0, 40.0)
    sm[1, 30:34, 2:6] = (3.0, 4.0)
    batch["size_map"] = sm
    total, metrics = jax.jit(s["det"].loss)(tree(s["variables"]), jnp_batch(batch))
    got, got_metrics = port_model("PointsProposalGenerator", s["variables"]).loss(batch)
    assert float(got.detach()) == pytest.approx(float(total), rel=LOSS_RTOL)
    for k, v in metrics.items():
        assert float(got_metrics[k].detach()) == pytest.approx(float(v), rel=LOSS_RTOL,
                                                               abs=1e-7), k
    assert float(got_metrics["border_likely_loss_0"]) == 0.0


@pytest.mark.parametrize("mode", ["point", "inside"])
def test_rpg_assignment_equals_jax_exactly(setups, mode):
    """Both SAMPLE_MODEs on integer-pixel boxes with a duplicate (ties in
    distance), at 256 x 384."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, **{
        "MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE": mode}))
    model = torch_build_model(tiny_cfg(torch_get_cfg, **{
        "MODEL.PROPOSAL_GENERATOR.SAMPLE_MODE": mode}), device="cpu")
    rs = np.random.RandomState(63)
    boxes = int_boxes(rs, (2, 10), 250, 4, 300)
    boxes[0, 3] = boxes[0, 2]
    valid = np.ones((2, 10), bool)
    valid[:, -3:] = False
    hw = (256, 384)
    centers, counts, lvls = det._centers(hw)
    stride = np.concatenate([np.full(c, s, np.float32) for c, s in zip(counts, det.strides)])
    want_obj, want_boxes = det._assign(centers, lvls, jnp.asarray(stride),
                                       {"gt_boxes": jnp.asarray(boxes),
                                        "gt_valid": jnp.asarray(valid)})
    got_obj, got_boxes, _ = model.targets(torch.from_numpy(boxes), torch.from_numpy(valid), hw)
    np.testing.assert_array_equal(got_obj.numpy(), np.asarray(want_obj))
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(want_boxes))
    assert int(got_obj.sum()) >= 7


def test_rpg_ohem_with_no_positive_is_finite(setups):
    batch = train_batch(64)
    batch["gt_valid"][:] = False
    model = port_model("RepPointsGenerator", setups["RepPointsGenerator"]["variables"])
    total, metrics = model.loss(batch)
    total.backward()
    assert np.isfinite(float(total.detach())) and float(metrics["num_pos"]) == 0
    assert float(metrics["cls_loss"].detach()) == pytest.approx(0.0, abs=1e-6)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)


def test_likelihood_loss_matches_jax():
    rs = np.random.RandomState(65)
    B, P, Hf, Wf, H, W = 2, 3, 4, 5, 16, 20
    target = rs.rand(B, H, W).astype(np.float32)
    coords = rs.rand(B, P, Hf, Wf, 2).astype(np.float32) * 2.4 - 1.2     # some outside
    mask = (rs.rand(B, H, W) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jppg.likelihood_loss(jnp.asarray(target), jnp.asarray(coords),
                                    None if m is None else jnp.asarray(m))
        got = tppg.likelihood_loss(torch.from_numpy(target), torch.from_numpy(coords),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_size_map_in_chunks_equals_jax_exactly(monkeypatch):
    """Chunks of 3 gts (the budget cut to 3 images' worth of pixels) and one
    chunk of all: both equal the JAX package's (B, G, H, W) reduction."""
    rs = np.random.RandomState(66)
    hw = (40, 56)
    boxes = int_boxes(rs, (2, 8), 40, 2, 30)
    boxes[1, 2] = boxes[1, 5]
    valid = rs.rand(2, 8) > 0.25
    want = np.asarray(jppg._sizes_from_boxes(jnp.asarray(boxes), jnp.asarray(valid), hw))
    for budget in (3 * hw[0] * hw[1], tppg.SIZE_CHUNK_ELEMENTS):
        monkeypatch.setattr(tppg, "SIZE_CHUNK_ELEMENTS", budget)
        got = tppg.sizes_from_boxes(torch.from_numpy(boxes), torch.from_numpy(valid), hw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2


# ------------------------------------------------------------ predict
@pytest.mark.parametrize("name", GENERATORS)
def test_predict_matches_jax_slot_for_slot(setups, name):
    s = setups[name]
    batch = predict_batch(67)
    want = jax.jit(s["det"].predict)(tree(s["variables"]), jnp_batch(batch))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = port_model(name, s["variables"]).predict(batch)
    assert sorted(got) == sorted(want)
    valid = want["valid"]
    assert valid.sum(1).min() >= 20
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert got["classes"].dtype == torch.int32 and not got["classes"].any()
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid],
                               rtol=0, atol=1e-3)
    for k in ("proposals", "proposal_scores", "proposal_valid"):
        assert torch.equal(got[k], got[{"proposals": "boxes", "proposal_scores": "scores",
                                        "proposal_valid": "valid"}[k]])
    # not all boxes are one point: the regression spans pixels
    b = got["boxes"].numpy()[0][valid[0]]
    assert (b[:, 2] - b[:, 0]).max() > 4


# ---------------------------------------------------------- the entry point
NAME = "torch_proposal_synth"
TINY_MAIN = {
    "MODEL.META_ARCHITECTURE": "ProposalNetwork",
    "MODEL.PROPOSAL_GENERATOR.NAME": "RepPointsGenerator",
    "MODEL.RPN.IN_FEATURES": "['p3','p4','p5','p6','p7']",
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.BASE_LR": 0.001,
    "SOLVER.WARMUP_ITERS": 3, "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_proposal")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    tcatalog.DatasetCatalog.remove(NAME)
    tcoco.register_coco_instances(NAME, path, root)
    return tmp


def cli_args(out, *flags, **overrides):
    opts = {**TINY_MAIN, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(FCOS_YAML), *flags] + [str(x) for kv in opts.items() for x in kv])


def test_main_trains_resumes_bit_equal_and_evaluates(synth, monkeypatch):
    """1 iteration and a checkpoint, ``--resume`` to 2, against a run that
    went 0 -> 2 on the same batches: the model (the head's BatchNorm running
    statistics included), momentum and iteration equal bit for bit; then
    ``--eval-only`` of class-0 proposals."""
    k, n = 1, 2
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
    assert float(saved["model"]["head.objectness_norm0.running_var"].mean()) != 1.0
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
    for key in got["model"]:
        assert torch.equal(got["model"][key], want["model"][key]), key
    assert not torch.equal(got["model"]["head.deltas_norm1.running_mean"],
                           saved["model"]["head.deltas_norm1.running_mean"])
    for s_got, s_want in zip(got["optimizer"]["state"].values(),
                             want["optimizer"]["state"].values()):
        assert torch.equal(s_got["momentum_buffer"], s_want["momentum_buffer"])

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", real_loader)
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **{"SOLVER.MAX_ITER": n}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]
