"""The port's RotatedRetinaNet (``models/meta_arch/retina_rotated.py``) held
against the JAX package's on the CPU, in float32 at a tiny size (R-18,
64 x 64 images, 8 padded gt, the reduced anchor set of
``tests/test_rotated_model.py``: one size a level, ratios 0.5 and 1, angles
-45, 0, 45):

- the rotated anchors bit for bit, of the YAML (27 a cell; 708,939 at
  896 x 1408) and of the reduced set;
- ``rotated_label_anchors`` (low-quality matching, int8 label codes)
  exactly, the matched gt too;
- the head's 5-delta outputs, the loss (1e-4) and every trained tensor's
  gradient (1e-3 of its largest entry), the all-padded batch finite;
- predict slot for slot in two parts (the NMS input: validity and classes
  exactly, scores 1e-5, boxes 1e-3 px plus 1e-5 of their size; the port's
  NMS on the JAX input keep list for keep list);
- ``train_net_torch.main`` over 4 steps on an ``rcoco`` dataset written with
  rotated polygons (``rbox_from_polygon`` gives the ground truth), evaluated
  by the ``rcoco`` evaluator, and a resumed run bit-equal to an
  uninterrupted one.

The JAX side is compiled at XLA's backend optimisation level 0, where, as
in the port and the CUDA kernels, every operation is rounded on its own
(``tests/test_torch_rotated_ops.py``: at the default level XLA contracts
the rotated IoU's products into FMAs, which at the class offsets of the NMS
moves an IoU by up to 0.03). Both sides get the same weights through
``checkpoint/bridge.py``; every input is made from a numpy seed inside its
test, the gt angles from a set on which the two packages' sin and cos
agree.
"""

import json
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
from test_torch_rcnn import _states_equal  # noqa: E402
from test_torch_rotated_ops import ANGLES, jax_exact  # noqa: E402

import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import rotated_coco as trcoco  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.engine.train_loop import TrainStep  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import anchors as tanchors  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import retina_rotated as trr  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import anchors as janchors  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import retina_rotated as jrr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/rotated/rotated_retinanet_R_50_FPN_1x.yaml"
REDUCED = {"MODEL.ANCHOR_GENERATOR.SIZES": [[32], [64], [128], [256], [512]],
           "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[0.5, 1.0]],
           "MODEL.ANCHOR_GENERATOR.ANGLES": [[-45, 0, 45]]}
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: under the tier's six
    workers on one shared CPU, eight threads a process make the port's many
    small operations (the plain clip, the NMS loop) wait on each other
    (``tests/test_torch_proposal.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in {**REDUCED, **overrides}.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def rotated_batch(seed, batch=2, g=8, hw=(64, 64)):
    """uint8 images and integer-pixel gt rboxes (angles from ``ANGLES``),
    the last two rows of each image padding."""
    rs = np.random.RandomState(seed)
    rboxes = np.stack([rs.randint(10, 54, (batch, g)), rs.randint(10, 54, (batch, g)),
                       rs.randint(6, 40, (batch, g)), rs.randint(3, 16, (batch, g)),
                       rs.choice(ANGLES, (batch, g))], -1).astype(np.float32)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_rboxes": rboxes,
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


# ----------------------------------------------------------------- anchors
@pytest.mark.parametrize("reduced,image_hw,total", [
    (False, (64, 64), None), (False, (896, 1408), 708939), (False, (1408, 896), 708939),
    (True, (64, 96), None)])
def test_rotated_anchors_equal_the_jax_packages_bit_for_bit(reduced, image_hw, total):
    strides = [8, 16, 32, 64, 128]
    cfgs = []
    for get_cfg in (jax_get_cfg, torch_get_cfg):
        cfg = get_cfg()
        cfg.merge_from_file(str(CONFIG))
        if reduced:
            cfg.merge_from_list([x for kv in REDUCED.items() for x in kv])
        cfgs.append(cfg)
    want = janchors.RotatedAnchorGeneratorSpec(cfgs[0], strides)
    got = tanchors.RotatedAnchorGeneratorSpec(cfgs[1], strides)
    assert got.num_cell_anchors == want.num_cell_anchors == [6 if reduced else 27] * 5
    for g, w in zip(got.cell_anchors, want.cell_anchors):
        np.testing.assert_array_equal(g, w)
    (ga, gc), (wa, wc) = got.anchors(image_hw), want.anchors(image_hw)
    assert gc == wc and ga.dtype == wa.dtype == np.float32 and ga.shape[1] == 5
    np.testing.assert_array_equal(ga, wa)
    if total is not None:
        assert sum(gc) == total


def test_rotated_label_anchors_equal_jax_exactly():
    """The reduced anchors at 64 x 96 against integer rboxes, duplicated,
    degenerate (w 0) and padded gt; thresholds (0.4, 0.5) with labels
    (0, -1, 1)."""
    cfg = tiny_cfg(torch_get_cfg)
    anchors, _ = tanchors.RotatedAnchorGeneratorSpec(cfg, [8, 16, 32, 64, 128]).anchors((64, 96))
    batch = rotated_batch(60, batch=3, g=10, hw=(64, 96))
    gt = batch["gt_rboxes"]
    gt[0, 1] = gt[0, 0]
    gt[1, 2, 2] = 0.0
    classes, valid = batch["gt_classes"], batch["gt_valid"]
    valid[2] = False                                    # no gt at all
    args = (anchors, gt, classes, valid)
    want_labels, want_matched = jax_exact(jax.vmap(
        lambda a, g, c, v: jrr.rotated_label_anchors(a, g, c, v, [0.4, 0.5], [0, -1, 1], 80),
        in_axes=(None, 0, 0, 0)), *args)
    for b in range(3):
        labels, matched = trr.rotated_label_anchors(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in (anchors, gt[b], classes[b],
                                                                  valid[b])),
            [0.4, 0.5], [0, -1, 1], 80)
        np.testing.assert_array_equal(labels.numpy(), want_labels[b])
        np.testing.assert_array_equal(matched.numpy(), want_matched[b])
    fg = (want_labels[:2] >= 0) & (want_labels[:2] < 80)
    assert fg.sum() >= 8 and (want_labels[:2] == -1).sum() > 0
    assert (want_labels[2] == 80).all()


# ------------------------------------------------------------------ model
def _randomize(variables, seed, cls_std=None, cls_bias=0.0):
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    for node in jax.tree_util.tree_leaves(
            out["buffers"], is_leaf=lambda v: isinstance(v, dict) and "scale" in v):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    if cls_std is not None:
        cls = out["params"]["head"]["cls_score"]
        cls["kernel"] = (rs.randn(*cls["kernel"].shape) * cls_std).astype(np.float32)
        cls["bias"][:] = cls_bias
    return out


@pytest.fixture(scope="module")
def rotated_pair():
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    variables = _randomize(det.init_variables(jax.random.PRNGKey(0)), seed=61)
    return det, variables


def torch_model(variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


def test_bridge_and_head_outputs_match_jax(rotated_pair):
    det, variables = rotated_pair
    model = torch_model(variables)
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert sd["head.bbox_pred.weight"].shape == (6 * 5, 256, 3, 3)
    assert isinstance(model.head, trr.RotatedHead) and model.head.box_dim == 5
    images = rotated_batch(62, hw=(64, 96))["image"]
    want_logits, want_regs = jax_exact(
        lambda v, x: det.module.apply(v, x),
        jax.tree_util.tree_map(jnp.asarray, variables), images)
    with torch.no_grad():
        logits, regs = model(torch.from_numpy(images))
    cells = [8 * 12, 4 * 6, 2 * 3, 1 * 2, 1 * 1]
    for lvl in range(5):
        assert tuple(regs[lvl].shape) == want_regs[lvl].shape == (2, cells[lvl] * 6, 5)
        np.testing.assert_allclose(logits[lvl].numpy(), want_logits[lvl], **HEAD_TOL)
        np.testing.assert_allclose(regs[lvl].numpy(), want_regs[lvl], **HEAD_TOL)


@pytest.fixture(scope="module")
def jax_losses(rotated_pair):
    det, variables = rotated_pair
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    batch = rotated_batch(63)
    empty = {**batch, "gt_valid": np.zeros_like(batch["gt_valid"])}

    def loss_fn(params, b):
        return det.loss({"params": params, "buffers": jvars["buffers"]}, b)

    args = (jvars["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    compiled = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    out = {"batch": batch, "empty_batch": empty}
    for key, b in (("full", batch), ("empty", empty)):
        (total, metrics), grads = compiled(jvars["params"],
                                           {k: jnp.asarray(v) for k, v in b.items()})
        out[key] = {"total": float(total),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": flax_to_state_dict(
                        {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    return out


def test_rotated_loss_and_gradients_match_jax(rotated_pair, jax_losses):
    _, variables = rotated_pair
    cfg = tiny_cfg(torch_get_cfg)
    model = torch_model(variables)
    tsolver.build_optimizer(cfg, model)                 # applies FREEZE_AT
    want = jax_losses["full"]
    total, metrics = model.loss(jax_losses["batch"])
    assert float(total.detach()) == pytest.approx(want["total"], rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(want["metrics"]) == ["loss_box_reg", "loss_cls", "num_pos"]
    for k, v in want["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=LOSS_RTOL), k
    assert float(metrics["num_pos"]) >= 8
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        assert ratio(p.grad.numpy(), want["grads"][name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"backbone.bottom_up.res4_0.conv1.weight", "backbone.fpn_output0.weight",
            "head.cls_subnet0.weight", "head.bbox_pred.weight", "head.bbox_pred.bias"} <= checked


def test_all_padded_batch_matches_jax_and_is_finite(rotated_pair, jax_losses):
    _, variables = rotated_pair
    model = torch_model(variables)
    total, metrics = model.loss(jax_losses["empty_batch"])
    assert float(total.detach()) == pytest.approx(jax_losses["empty"]["total"], rel=LOSS_RTOL)
    assert float(metrics["num_pos"]) == 1.0 and float(metrics["loss_box_reg"]) == 0.0
    total.backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)
    assert float(model.head.bbox_pred.weight.grad.abs().max()) == 0.0


def jax_candidates(det, variables, images):
    """The JAX predict's NMS input, its own code up to the NMS
    (``retina_rotated.py:RotatedRetinaNet.predict``), compiled exactly."""
    from slenderobjdet_tpu.ops.rotated import apply_rotated_deltas
    from slenderobjdet_tpu.ops.topk import pair_top_k

    anchors_np, counts = det.anchor_spec.anchors(images.shape[1:3])
    offsets = np.concatenate([[0], np.cumsum(counts)])

    def fn(v, x):
        logits_l, regs_l = det.module.apply(v, x)
        out = []
        for lvl in range(len(counts)):
            lvl_anchors = jnp.asarray(anchors_np[offsets[lvl]: offsets[lvl + 1]])
            scores = jax.nn.sigmoid(logits_l[lvl].astype(jnp.float32))
            top, a_idx, cls_idx = pair_top_k(scores, det.topk_candidates, approx=False)
            sel = jnp.take_along_axis(regs_l[lvl], a_idx[..., None], axis=1)
            out.append((apply_rotated_deltas(sel, lvl_anchors[a_idx],
                                             weights=det.box_reg_weights),
                        top, cls_idx, top > det.score_thresh))
        return tuple(jnp.concatenate(t, axis=1) for t in zip(*out))

    return jax_exact(fn, variables, images)


def test_rotated_predict_matches_jax(rotated_pair):
    """Predict slot for slot, in two parts. The NMS input (the levels' top-k
    pairs decoded): validity and classes exactly, scores 1e-5, boxes 1e-3
    px plus 1e-5 of their size (the anchors reach 512 px, and the decoded
    sides several hundred). The NMS on that input: the port's on the JAX candidates equals the
    JAX package's, keep list for keep list, and each package's predict is
    its NMS on its own candidates. The two predicts are not compared slot
    for slot as a whole: the class offsets (4096 x class, up to 323,584)
    leave float32 an ulp of up to 1/32 px, so the shoelace sums there
    cancel and an IoU moves by a large fraction under a 1e-4 px change of a
    box, which the two packages' head convolutions differ by. The
    classifier drawn at std 0.005 (logits of std 0.44) with bias -4.6 puts
    about one score in a thousand over SCORE_THRESH_TEST: a few dozen an
    image."""
    from slenderobjdet_torch.ops.rotated import offset_boxes, rotated_nms
    from slenderobjdet_tpu.ops.rotated import rotated_nms as jax_rotated_nms

    _, variables = rotated_pair
    variables = _randomize(variables, seed=64, cls_std=0.005, cls_bias=-4.6)
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    model = torch_model(variables)
    rs = np.random.RandomState(65)
    batch = {"image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "scale": np.array([1.0, 0.8], np.float32),
             "orig_size": np.array([[64, 64], [51, 51]], np.float32)}
    want_c = jax_candidates(det, variables, batch["image"])
    with torch.no_grad():
        got_c = model.candidates(*model(torch.from_numpy(batch["image"])), (64, 64))
    v = want_c[3]
    assert ((v.sum(1) >= 20) & (v.sum(1) < 200)).all(), v.sum(1)
    np.testing.assert_array_equal(got_c[3].numpy(), v)
    np.testing.assert_array_equal(got_c[2].numpy()[v], want_c[2][v])
    np.testing.assert_allclose(got_c[1].numpy()[v], want_c[1][v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_c[0].numpy()[v], want_c[0][v], rtol=1e-5, atol=1e-3)

    def nms(boxes, scores, classes, valid):
        return rotated_nms(offset_boxes(torch.from_numpy(boxes), torch.from_numpy(classes)),
                           torch.from_numpy(scores), det.nms_thresh, det.max_dets,
                           valid=torch.from_numpy(valid))

    got_keep = nms(*want_c)
    shifted = offset_boxes(torch.from_numpy(want_c[0]), torch.from_numpy(want_c[2])).numpy()
    want_keep = jax_exact(jax.vmap(lambda b, s, m: jnp.stack(jax_rotated_nms(
        b, s, det.nms_thresh, det.max_dets, valid=m))), shifted, want_c[1], v)
    np.testing.assert_array_equal(got_keep[0].numpy(), want_keep[:, 0])
    np.testing.assert_array_equal(got_keep[1].numpy(), want_keep[:, 1].astype(bool))

    want = jax_exact(det.predict, variables, batch)
    got = model.predict(batch)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores", "valid"]
    assert got["boxes"].shape == want["boxes"].shape == (2, 100, 5)
    assert got["classes"].dtype == torch.int32 and 10 <= int(got["valid"].sum()) < 200
    scale = np.array([1.0, 0.8], np.float32)[:, None, None]
    for out, cands, keep in ((got, [t.numpy() for t in got_c], nms(*[t.numpy() for t in got_c])),
                             (want, want_c, (want_keep[:, 0], want_keep[:, 1].astype(bool)))):
        idx, kv = (np.asarray(k) for k in keep)
        np.testing.assert_array_equal(np.asarray(out["valid"]), kv)
        kept = np.take_along_axis(cands[0], idx[..., None].astype(np.int64), 1)
        kept[..., :4] /= scale
        np.testing.assert_array_equal(np.asarray(out["boxes"])[kv], kept[kv])
        np.testing.assert_array_equal(np.asarray(out["classes"])[kv],
                                      np.take_along_axis(cands[2], idx, 1)[kv])


# ----------------------------------------------------------------- trainer
NAME = "torch_rcoco_retina_synth"
TINY = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.RETINANET.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.CHECKPOINT_PERIOD": 100,
    "SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 3, **REDUCED,
}


def rcoco_dataset(tmp, name):
    """A COCO json whose segmentations are turned quadrilaterals inside each
    box (so that ``rbox_from_polygon`` gives rotated ground truth),
    registered under ``name`` as an ``rcoco`` dataset in the port's
    catalog."""
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    with open(path) as f:
        data = json.load(f)
    rs = np.random.RandomState(66)
    for a in data["annotations"]:
        x, y, w, h = a["bbox"]
        cx, cy = x + rs.randint(1, max(int(w), 2)), y + rs.randint(1, max(int(h), 2))
        a["segmentation"] = [[cx, y, x + w, cy, x + w - (cx - x), y + h, x, y + h - (cy - y)]]
    with open(path, "w") as f:
        json.dump(data, f)
    tcatalog.DatasetCatalog.remove(name)
    trcoco.register_rotated_coco_instances(name, path, root)
    return path


def cli_args(config, tiny, out, *flags, **overrides):
    opts = {**tiny, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(config), *flags] + [str(x) for kv in opts.items() for x in kv])


def resumed_run_is_bit_equal(tmp, config, tiny, monkeypatch, k=2, n=4):
    """``main`` for k iterations and a checkpoint, ``--resume`` to n with
    the rcoco evaluation, against a run that went 0 -> n on the same
    batches: the same state bit for bit. Returns the resumed run's results
    and the dataset dicts the loader read."""
    trainers = []
    real_train = ttrainer.BaseTrainer.train

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    out = tmp / "resumed"
    train_net_torch.main(cli_args(config, tiny, out, "--device", "cpu",
                                  **{"SOLVER.MAX_ITER": k, "DATASETS.TEST": ()}))
    results = train_net_torch.main(cli_args(config, tiny, out, "--device", "cpu", "--resume",
                                            **{"SOLVER.MAX_ITER": n}))
    assert trainers[1].start_iter == k
    real_loader = ttrainer.build_detection_train_loader

    def restarting_loader(cfg, seed=0):
        def stream():
            head = iter(real_loader(cfg, seed=seed))
            for _ in range(k):
                yield next(head)
            yield from real_loader(cfg, seed=seed)
        return stream()

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", restarting_loader)
    train_net_torch.main(cli_args(config, tiny, tmp / "straight", "--device", "cpu",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    _states_equal(got, want)
    return results


def test_rotated_retinanet_main_resumes_bit_equal_and_evaluates(tmp_path, monkeypatch):
    rcoco_dataset(tmp_path, NAME)
    dicts = tcatalog.DatasetCatalog.get(NAME)
    angles = [a["rbox"][4] for d in dicts for a in d["annotations"]]
    assert len(angles) > 6 and any(a != 0 for a in angles)
    assert tcatalog.MetadataCatalog.get(NAME).evaluator_type == "rcoco"
    steps = []
    real_call = TrainStep.__call__

    def recording_call(self, batch):
        assert batch["gt_rboxes"].shape[-1] == 5
        out = real_call(self, batch)
        steps.append(out)
        return out

    monkeypatch.setattr(TrainStep, "__call__", recording_call)
    results = resumed_run_is_bit_equal(tmp_path, CONFIG, TINY, monkeypatch)
    assert all(np.isfinite(float(s["total_loss"])) for s in steps) and len(steps) == 8
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"])
