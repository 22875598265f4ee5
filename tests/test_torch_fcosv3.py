"""FCOSV3 and the maps the loader feeds the mask-supervised detectors, held
against the JAX package on the CPU, in float32 at the tiny size:

- ``mask_center_gate`` (JAX ``fcos.py:363-373``: the centre score read at
  each location's truncated pixel, positives at or below 0.2 made
  background) exactly against the JAX expression, copied here, on a
  polygon-rendered map; ``FCOSV3.loss`` against ``jax.jit(det.loss)`` on the
  tiny flagship (R-18, 64 x 64, weights through ``checkpoint/bridge.py``):
  labels and ``num_pos`` exactly, each loss term within LOSS_RTOL, every
  trainable gradient within GRAD_TOL of the largest (as
  ``tests/test_torch_train.py`` holds FCOS), on a centre map rendered from
  the gt polygons that puts positives on both sides of 0.2;
- ``ProposalNetworkWithMasks.loss`` against the JAX loss on a batch the
  port's mapper made (its ``center_mask``, ``border_mask``, ``size_map``);
- the registry's 26 names with FCOSV3 among them, FCOSV3's Flax tree through
  the bridge, and ``train_net_torch.main`` on
  ``configs/fcos/fcosv3_R_50_FPN_1x.yaml``: train, ``--resume`` bit-equal,
  evaluate.

Every input comes from a numpy generator seeded in its test; each JAX
detector is compiled once in this module.
"""

import os
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402
from test_torch_proposal import randomize, tiny_cfg  # noqa: E402

import __graft_entry__  # noqa: E402
import train_net_torch  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data import mapper as tmapper  # noqa: E402
from slenderobjdet_torch.data.build import _stack_batch  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import fcos as tfcos  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_torch.structures.borders import BorderMasks  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import fcos as jfcos  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V3_YAML = ROOT / "configs/fcos/fcosv3_R_50_FPN_1x.yaml"
LOSS_RTOL = 1e-5     # tests/test_torch_train.py: each loss term
PNWM_LOSS_RTOL = 1e-4    # tests/test_torch_proposal.py: each loss term
GRAD_TOL = 1e-3      # tests/test_torch_train.py: per tensor, max |diff| / max |JAX grad|
HW = (64, 64)


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def port_cfg(**overrides):
    """The FCOSV3 yaml at the tiny flagship's size: R-18, fp32."""
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(V3_YAML))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def jax_cfg():
    cfg = __graft_entry__._flagship_cfg(tiny=True)
    cfg.defrost()
    cfg.MODEL.META_ARCHITECTURE = "FCOSV3"
    cfg.NEED_MASKS = True
    cfg.freeze()
    return cfg


def v3_batch(seed=0, batch=2, g=8):
    """uint8 images, integer-pixel gt boxes (slender and compact, two of
    them padding) and the gaussian centre map of each box's polygon (a
    quadrilateral inside it touching all four sides), as the mapper renders
    it: locations near a box's centre score above 0.2, those near its
    border at or below."""
    rs = np.random.RandomState(seed)
    h, w = HW
    boxes = np.zeros((batch, g, 4), np.float32)
    masks = np.zeros((batch, h, w), np.float32)
    for b in range(batch):
        polys = []
        for k in range(g):
            bw, bh = (rs.randint(24, 44), rs.randint(4, 9)) if k % 2 else \
                (rs.randint(10, 36), rs.randint(10, 36))
            if rs.rand() < 0.5:
                bw, bh = bh, bw
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            boxes[b, k] = [x, y, x + bw, y + bh]
            cx, cy = x + rs.randint(1, bw), y + rs.randint(1, bh)
            polys.append([np.array([cx, y, x + bw, cy, x + bw - (cx - x), y + bh, x,
                                    y + bh - (cy - y)], np.float64)])
        masks[b] = BorderMasks(polys[:g - 2]).center_masks(HW, "gaussian", 0.5)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    return {"image": rs.randint(0, 256, (batch, h, w, 3)).astype(np.uint8),
            "gt_boxes": boxes, "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid, "center_mask": masks}


def jax_gate(labels, locations, cm, num_classes, thresh):
    """``FCOS.loss``'s gate in the JAX package (fcos.py:363-373), copied."""
    ix = jnp.clip(locations[:, 0].astype(jnp.int32), 0, cm.shape[2] - 1)
    iy = jnp.clip(locations[:, 1].astype(jnp.int32), 0, cm.shape[1] - 1)
    scores_at = cm[:, iy, ix]
    return jnp.where((labels < num_classes) & (scores_at <= thresh), num_classes, labels)


@pytest.fixture(scope="module")
def v3():
    """The tiny FCOSV3 in JAX, its loss, metrics and gradients on
    ``v3_batch`` (one compile)."""
    det = jax_build_model(jax_cfg())
    assert type(det).__name__ == "FCOSV3" and det.mask_center_sampling
    variables = det.init_variables(jax.random.PRNGKey(0), HW, 2)
    batch = v3_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        return det.loss({"params": params, "buffers": variables["buffers"]}, jbatch)

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return {"variables": jax.tree_util.tree_map(np.asarray, variables), "batch": batch,
            "total": float(total), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})}


def port_v3(variables, **overrides):
    model = torch_build_model(port_cfg(**overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


# ------------------------------------------------------------------ the gate
def test_mask_center_gate_equals_jax_exactly():
    """Labels after the gate, on the assignment of a 128 x 160 image of
    integer boxes, positives on both sides of the threshold."""
    locations, counts = tfcos.fcos_locations((128, 160), (8, 16, 32, 64, 128))
    soi = tfcos.sizes_of_interest(counts)
    batch = v3_batch(seed=3)
    rs = np.random.RandomState(4)
    boxes = (batch["gt_boxes"] * 2).astype(np.float32)
    cm = np.stack([BorderMasks([[np.array([b[0], b[1], b[2], b[1], b[2], b[3], b[0], b[3]],
                                          np.float64) + rs.randint(-2, 3, 8)]
                                for b in img]).center_masks((128, 160), "gaussian", 0.5)
                   for img in boxes])
    labels, _, _ = tfcos.fcos_assign(
        torch.from_numpy(locations), torch.from_numpy(soi), torch.from_numpy(boxes),
        torch.from_numpy(batch["gt_classes"]), torch.from_numpy(batch["gt_valid"]), 80)
    got = tfcos.mask_center_gate(labels, torch.from_numpy(locations), torch.from_numpy(cm),
                                 80, 0.2)
    want = jax_gate(jnp.asarray(labels.numpy()), jnp.asarray(locations), jnp.asarray(cm),
                    80, 0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos, kept = labels.numpy() < 80, got.numpy() < 80
    assert kept.sum() > 10 and (pos & ~kept).sum() >= 5
    # the score at a location's truncated pixel; a map of ones gates nothing
    ones = torch.ones(2, 128, 160)
    assert torch.equal(tfcos.mask_center_gate(labels, torch.from_numpy(locations), ones, 80,
                                              0.2), labels)


# ------------------------------------------------------------------ FCOSV3's loss
def test_fcosv3_labels_and_num_pos_equal_jax(v3):
    batch = v3_batch()
    locations, counts = tfcos.fcos_locations(HW, (8, 16, 32, 64, 128))
    soi = tfcos.sizes_of_interest(counts)
    jl, _, _ = jax.vmap(partial(jfcos.fcos_assign_single, num_classes=80),
                        in_axes=(None, None, 0, 0, 0))(
        jnp.asarray(locations), jnp.asarray(soi), jnp.asarray(batch["gt_boxes"]),
        jnp.asarray(batch["gt_classes"]), jnp.asarray(batch["gt_valid"]))
    want = np.asarray(jax_gate(jl, jnp.asarray(locations), jnp.asarray(batch["center_mask"]),
                               80, 0.2))
    tl, _, _ = tfcos.fcos_assign(
        torch.from_numpy(locations), torch.from_numpy(soi), torch.from_numpy(batch["gt_boxes"]),
        torch.from_numpy(batch["gt_classes"]), torch.from_numpy(batch["gt_valid"]), 80)
    got = tfcos.mask_center_gate(tl, torch.from_numpy(locations),
                                 torch.from_numpy(batch["center_mask"]), 80, 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    before = np.asarray(jl) < 80
    assert (got < 80).sum() > 5 and (before & (got == 80)).sum() > 5
    model = port_v3(v3["variables"])
    with torch.no_grad():
        _, metrics = model.loss(batch)
    assert float(metrics["num_pos"]) == v3["metrics"]["num_pos"] == float((want < 80).sum())


def test_fcosv3_loss_terms_and_gradients_match_jax(v3):
    model = port_v3(v3["variables"])
    assert type(model) is tfcos.FCOSV3 and model.mask_center_sampling
    tsolver.build_optimizer(port_cfg(), model)               # applies FREEZE_AT
    total, metrics = model.loss(v3["batch"])
    assert float(total.detach()) == pytest.approx(v3["total"], rel=LOSS_RTOL)
    for k in ("cls_loss", "reg_loss", "centerness_loss"):
        assert float(metrics[k].detach()) == pytest.approx(v3["metrics"][k], rel=LOSS_RTOL), k
    total.backward()
    n = 0
    for name, p in model.named_parameters():
        if tsolver.frozen(port_cfg(), name):
            assert p.grad is None, name
            continue
        n += 1
        assert ratio(p.grad.numpy(), v3["grads"][name].numpy()) <= GRAD_TOL, name
    assert n > 40


def test_fcosv3_without_a_center_mask_is_fcos(v3):
    """The gate needs the loader's map; a batch without one trains as FCOS,
    in both packages."""
    batch = {k: v for k, v in v3_batch().items() if k != "center_mask"}
    v3_model = port_v3(v3["variables"])
    fcos = torch_build_model(port_cfg(**{"MODEL.META_ARCHITECTURE": "FCOS"}), device="cpu")
    load_flax_variables(fcos, v3["variables"])
    with torch.no_grad():
        a, ma = v3_model.loss(batch)
        b, mb = fcos.loss(batch)
        _, mv = v3_model.loss(v3_batch())
    assert torch.equal(a, b) and torch.equal(ma["num_pos"], mb["num_pos"])
    assert float(mv["num_pos"]) < float(mb["num_pos"])


def test_registry_and_bridge_carry_fcosv3(v3):
    assert len(META_ARCHS) == 28 and META_ARCHS["FCOSV3"] is tfcos.FCOSV3
    model = port_v3(v3["variables"])
    leaves = jax.tree_util.tree_leaves(v3["variables"])
    assert len(flax_to_state_dict(v3["variables"])) == len(leaves) == len(model.state_dict())
    full = torch_get_cfg()
    full.merge_from_file(str(V3_YAML))
    assert full.NEED_MASKS and full.MODEL.RESNETS.DEPTH == 50
    assert type(torch_build_model(full, device="cpu")) is tfcos.FCOSV3


# ------------------------------------------------------------------ PNWM on mapper maps
def pnwm_mapper_batch(seed=7):
    """Two landscape examples the port's mapper made from inlined polygon
    dicts (NEED_MASKS, ProposalNetworkWithMasks): 128 x 128 padded, with
    ``center_mask``, ``border_mask`` and ``size_map``."""
    cfg = tiny_cfg(torch_get_cfg, "ProposalNetworkWithMasks", "ProposalNetworkWithMasks", **{
        "NEED_MASKS": True, "INPUT.MIN_SIZE_TRAIN": (48,), "INPUT.MAX_SIZE_TRAIN": 64,
        "TPU.MAX_GT_PER_IMAGE": 6})
    mapper = tmapper.DatasetMapper(cfg, is_train=True)
    rs = np.random.RandomState(seed)
    examples = []
    for i in range(2):
        annos = []
        for k in range(5):
            bw, bh = (rs.randint(20, 40), rs.randint(3, 6)) if k % 2 else \
                (rs.randint(8, 24), rs.randint(8, 24))
            x, y = rs.randint(0, 64 - bw), rs.randint(0, 48 - bh)
            annos.append({"bbox": [float(x), float(y), float(x + bw), float(y + bh)],
                          "category_id": 0, "iscrowd": 0,
                          "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
        examples.append(mapper({"image": rs.randint(0, 256, (48, 64, 3)).astype(np.uint8),
                                "image_id": i, "annotations": annos},
                               rng=np.random.default_rng((seed, i))))
    batch = _stack_batch(examples)
    return {k: batch[k] for k in ("image", "gt_boxes", "gt_classes", "gt_valid",
                                  "center_mask", "border_mask", "size_map")}


@pytest.mark.parametrize("with_maps", [True, False])
def test_pnwm_loss_on_mapper_maps_matches_jax(with_maps):
    """The objectness target is the loader's centre map where there is one,
    the in-box mask otherwise; the border and size maps ride along."""
    batch = pnwm_mapper_batch()
    assert batch["image"].shape == (2, 128, 128, 3) and batch["size_map"].shape == (2, 128, 128, 2)
    assert batch["center_mask"].max() > 0.9 and batch["size_map"].max() > 1.0
    if not with_maps:
        batch = {k: v for k, v in batch.items() if k not in ("center_mask", "border_mask",
                                                              "size_map")}
    det = jax_build_model(tiny_cfg(jax_get_cfg, "ProposalNetworkWithMasks"))
    variables = randomize(det.init_variables(jax.random.PRNGKey(2)),
                          "ProposalNetworkWithMasks", 52)
    total, metrics = jax.jit(det.loss)(jax.tree_util.tree_map(jnp.asarray, variables),
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_build_model(tiny_cfg(torch_get_cfg, "ProposalNetworkWithMasks"), device="cpu")
    load_flax_variables(model, variables)
    with torch.no_grad():
        t_total, t_metrics = model.loss(batch)
    assert float(t_total) == pytest.approx(float(total), rel=PNWM_LOSS_RTOL)
    for k in ("loss_objectness", "loss_reg"):
        assert float(t_metrics[k]) == pytest.approx(float(metrics[k]), rel=PNWM_LOSS_RTOL), k
    assert float(t_metrics["num_pos"]) == float(metrics["num_pos"]) > 2


# ------------------------------------------------------------------ the entry point
NAME = "torch_fcosv3_synth"
TINY_MAIN = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", "TPU.MAX_GT_PER_IMAGE": 10,
    "MODEL.FCOS.NUM_CLASSES": 3, "MODEL.FCOS.INFERENCE_TH": 0.0,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.BASE_LR": 0.001,
    "SOLVER.WARMUP_ITERS": 3, "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fcosv3")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80), slender=True, seed=8)
    tcatalog.DatasetCatalog.remove(NAME)
    tcoco.register_coco_instances(NAME, path, root)
    return tmp


def cli_args(out, *flags, **overrides):
    opts = {**TINY_MAIN, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(V3_YAML), *flags] + [str(x) for kv in opts.items() for x in kv])


@pytest.fixture(autouse=False)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_trains_resumes_bit_equal_and_evaluates(synth, monkeypatch, one_torch_thread):
    """1 iteration and a checkpoint, ``--resume`` to 2, against a run that
    went 0 -> 2 on the same batches: model, momentum and iteration equal bit
    for bit; every step's batch carries the polygon-rendered centre map and
    the gate removes positives; then ``--eval-only``."""
    k, n = 1, 2
    trainers, batches = [], []
    real_train = ttrainer.BaseTrainer.train
    real_loss = tfcos.FCOSV3.loss

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    def recording_loss(self, batch):
        batches.append(batch)
        return real_loss(self, batch)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    monkeypatch.setattr(tfcos.FCOSV3, "loss", recording_loss)
    out = synth / "resumed"
    train_net_torch.main(cli_args(out, "--device", "cpu", **{"SOLVER.MAX_ITER": k,
                                                             "DATASETS.TEST": ()}))
    assert type(trainers[0].model) is tfcos.FCOSV3
    first = batches[0]
    assert first["center_mask"].shape == first["image"].shape[:3]
    assert first["center_mask"].dtype == np.float32 and first["center_mask"].max() > 0.9
    assert "size_map" not in first
    with torch.no_grad():
        gated = trainers[0].model.loss(first)[1]["num_pos"]
        ungated = trainers[0].model.loss({k_: v for k_, v in first.items()
                                          if k_ != "center_mask"})[1]["num_pos"]
    assert 0 < float(gated) < float(ungated)
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
    for key in want["model"]:
        assert torch.equal(got["model"][key], want["model"][key]), key
    for s_got, s_want in zip(got["optimizer"]["state"].values(),
                             want["optimizer"]["state"].values()):
        assert torch.equal(s_got["momentum_buffer"], s_want["momentum_buffer"])

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", real_loader)
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **{"SOLVER.MAX_ITER": n}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]
