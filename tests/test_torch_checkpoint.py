"""The PyTorch port's checkpoints on the CPU: save and load round trips, the
``last_checkpoint`` pointer written only after the data, a failed background
save re-raised by ``wait()``, the snapshot a background save takes, the
detectron2 ``.pkl`` import held bit for bit against the JAX package's import
followed by the weight bridge, and resume: a run that saved at iteration k,
was rebuilt and resumed, then ran to n ends with parameters, momentum
buffers and iteration bit-equal to the run that went 0 -> n without
stopping. Tiny sizes (R-18, 64 x 64); every input is made from a seed here.
"""

import os
import pickle
import re
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

from slenderobjdet_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import register_coco_instances  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.solver import build_optimizer  # noqa: E402
from slenderobjdet_tpu.checkpoint import checkpointer as jckpt  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402

CONFIG = Path(__file__).resolve().parents[1] / "configs/fcos/fcos_R_50_FPN_1x.yaml"
NAME = "torch_ckpt_synth"
TINY = {"MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32"}
NARROW_R50 = {"MODEL.RESNETS.DEPTH": 50, "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
              "MODEL.RESNETS.RES2_OUT_CHANNELS": 32, "MODEL.RESNETS.STEM_OUT_CHANNELS": 16,
              "MODEL.FPN.OUT_CHANNELS": 32, "TPU.COMPUTE_DTYPE": "float32"}


def make_cfg(get_cfg, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def tiny_model_and_step(seed=0, **overrides):
    cfg = make_cfg(torch_get_cfg, **TINY, **overrides)
    model = torch_build_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    optimizer = build_optimizer(cfg, model)
    return cfg, model, optimizer, make_train_step(model, optimizer, cfg)


def tiny_batch(seed=0):
    rs = np.random.RandomState(seed)
    xy = rs.randint(0, 30, (2, 4, 2))
    wh = rs.randint(6, 30, (2, 4, 2))
    return {"image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "gt_boxes": np.concatenate([xy, xy + wh], 2).astype(np.float32),
            "gt_classes": rs.randint(0, 80, (2, 4)).astype(np.int32),
            "gt_valid": np.ones((2, 4), bool)}


def assert_states_equal(got, want, path=""):
    """Nested dicts and lists of tensors and plain values, bit for bit."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_states_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_states_equal(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def state_of(model, optimizer, step):
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "iteration": step.count}


# ------------------------------------------------------------- save / load
def test_save_load_round_trip_restores_model_optimizer_and_iteration(tmp_path):
    cfg, model, optimizer, step = tiny_model_and_step()
    for s in range(2):
        step(tiny_batch(s))
    ckpt = tckpt.DetectionCheckpointer(str(tmp_path))
    assert not ckpt.has_checkpoint() and ckpt.get_checkpoint_file() is None
    ckpt.save("model_0000002", state_of(model, optimizer, step))
    assert ckpt.has_checkpoint()
    assert ckpt.get_checkpoint_file() == str(tmp_path / "model_0000002")
    assert (tmp_path / "model_0000002.pth").exists() and not list(tmp_path.glob("*.tmp"))
    loaded = ckpt.load(ckpt.get_checkpoint_file())
    assert_states_equal(loaded, state_of(model, optimizer, step))
    assert loaded["iteration"] == 2
    assert any("momentum_buffer" in s for s in loaded["optimizer"]["state"].values())

    _, model2, optimizer2, step2 = tiny_model_and_step(seed=9)
    assert ckpt.resume_or_load("", model2, optimizer2, resume=True) == 2
    step2.count = 2
    assert_states_equal(state_of(model2, optimizer2, step2), state_of(model, optimizer, step))
    # without --resume the checkpoint is left alone: MODEL.WEIGHTS or the init
    _, model3, optimizer3, _ = tiny_model_and_step(seed=9)
    before = {k: v.clone() for k, v in model3.state_dict().items()}
    assert ckpt.resume_or_load("", model3, optimizer3, resume=False) == 0
    assert_states_equal(model3.state_dict(), before)
    # MODEL.WEIGHTS may name a checkpoint of this package: the model only
    assert ckpt.resume_or_load(str(tmp_path / "model_0000002.pth"), model3, optimizer3,
                               resume=False) == 0
    assert_states_equal(model3.state_dict(), model.state_dict())
    assert optimizer3.state_dict()["state"] == {}


def test_last_checkpoint_is_written_only_after_the_data(tmp_path, monkeypatch):
    ckpt = tckpt.DetectionCheckpointer(str(tmp_path))
    pointer = tmp_path / "last_checkpoint"
    seen = []
    real_save = torch.save

    def watching_save(obj, f, *a, **kw):
        seen.append(pointer.read_text() if pointer.exists() else None)
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", watching_save)
    ckpt.save("model_a", {"x": torch.arange(3)})
    assert pointer.read_text() == "model_a"
    ckpt.save("model_b", {"x": torch.arange(4)}, blocking=False)
    ckpt.wait()
    assert seen == [None, "model_a"] and pointer.read_text() == "model_b"

    def failing_save(obj, f, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save("model_c", {"x": torch.arange(5)})
    assert pointer.read_text() == "model_b" and not (tmp_path / "model_c.pth").exists()
    assert torch.equal(ckpt.load(ckpt.get_checkpoint_file())["x"], torch.arange(4))


def test_failed_background_save_is_reraised_by_wait(tmp_path, monkeypatch):
    ckpt = tckpt.DetectionCheckpointer(str(tmp_path))
    ckpt.save("model_a", {"x": torch.zeros(2)})

    def failing_save(obj, f, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    ckpt.save("model_b", {"x": torch.ones(2)}, blocking=False)      # returns at once
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as info:
        ckpt.wait()
    assert isinstance(info.value.__cause__, OSError)
    ckpt.wait()                                                     # raised once
    monkeypatch.undo()
    assert ckpt.get_checkpoint_file() == str(tmp_path / "model_a")
    # has_checkpoint / the next save join the failed one too
    monkeypatch.setattr(torch, "save", failing_save)
    ckpt.save("model_c", {"x": torch.ones(2)}, blocking=False)
    with pytest.raises(RuntimeError, match="async"):
        ckpt.has_checkpoint()


def test_background_save_writes_the_state_of_the_call(tmp_path, monkeypatch):
    """The optimizer updates tensors in place: a background save must write
    what they held when save() was called, whatever the next step does."""
    ckpt = tckpt.DetectionCheckpointer(str(tmp_path))
    w = torch.arange(6, dtype=torch.float32)
    state = {"model": {"w": w}, "optimizer": {"state": {0: {"m": w.clone()}},
                                              "param_groups": [{"lr": 0.1, "params": [0]}]},
             "iteration": 3}
    started, release = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(obj, f, *a, **kw):
        started.set()
        assert release.wait(timeout=30)
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", slow_save)
    ckpt.save("model_0000003", state, blocking=False)
    assert started.wait(timeout=30)
    w.mul_(-1)                                  # the next step's update
    state["optimizer"]["state"][0]["m"].zero_()
    release.set()
    ckpt.wait()
    loaded = ckpt.load(str(tmp_path / "model_0000003"))
    assert torch.equal(loaded["model"]["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(loaded["optimizer"]["state"][0]["m"],
                       torch.arange(6, dtype=torch.float32))
    assert loaded["iteration"] == 3 and loaded["optimizer"]["param_groups"][0]["lr"] == 0.1


def test_checkpoint_is_read_with_weights_only(tmp_path):
    """A file that needs arbitrary unpickling is refused."""
    ckpt = tckpt.DetectionCheckpointer(str(tmp_path))
    torch.save({"model": {}, "iteration": 1, "bad": threading.Event}, tmp_path / "evil.pth")
    with pytest.raises(pickle.UnpicklingError):
        ckpt.load(str(tmp_path / "evil"))


# -------------------------------------------------------------- d2 import
def d2_state_dict(model, rs):
    """A detectron2 model-zoo dict for ``model``: d2 names and OIHW arrays
    drawn from ``rs``, BatchNorm statistics for every FrozenBN, plus keys
    the import must pass over."""
    norm_after = {"norm1": "conv1", "norm2": "conv2", "norm3": "conv3",
                  "shortcut_norm": "shortcut"}
    out = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        m = re.fullmatch(r"backbone\.bottom_up\.(stem_conv1|stem_norm)\.(\w+)", key)
        if m:
            stem, leaf = m.groups()
            if stem == "stem_conv1":
                out["backbone.bottom_up.stem.conv1.weight"] = rs.randn(*shape)
            elif leaf == "scale":
                out.update(_bn_stats("backbone.bottom_up.stem.conv1.norm", shape, rs))
            continue
        m = re.fullmatch(r"backbone\.bottom_up\.res(\d)_(\d+)\.(\w+)\.(\w+)", key)
        if m:
            stage, block, mod, leaf = m.groups()
            prefix = f"backbone.bottom_up.res{stage}.{block}"
            if mod in norm_after:
                if leaf == "scale":
                    out.update(_bn_stats(f"{prefix}.{norm_after[mod]}.norm", shape, rs))
            else:
                out[f"{prefix}.{mod}.{leaf}"] = rs.randn(*shape)
            continue
        m = re.fullmatch(r"backbone\.fpn_(lateral|output)(\d)\.(weight|bias)", key)
        if m:       # d2 numbers them by stage: 3, 4, 5
            out[f"backbone.fpn_{m.group(1)}{int(m.group(2)) + 3}.{m.group(3)}"] = rs.randn(*shape)
            continue
        m = re.fullmatch(r"backbone\.top_p(\d)\.(weight|bias)", key)
        if m:
            out[f"backbone.top_block.p{m.group(1)}.{m.group(2)}"] = rs.randn(*shape)
    out["proposal_generator.rpn_head.conv.weight"] = rs.randn(4, 4, 3, 3)
    out["backbone.bottom_up.res9.0.conv1.weight"] = rs.randn(4, 4, 1, 1)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _bn_stats(prefix, shape, rs):
    return {f"{prefix}.weight": rs.rand(*shape) + 0.5, f"{prefix}.bias": rs.randn(*shape) * 0.1,
            f"{prefix}.running_mean": rs.randn(*shape) * 0.2,
            f"{prefix}.running_var": rs.rand(*shape) + 0.1}


@pytest.mark.parametrize("overrides", [TINY, NARROW_R50], ids=["r18", "narrow_r50"])
def test_d2_import_equals_the_jax_import_through_the_bridge(overrides, tmp_path):
    det = jax_build_model(make_cfg(jax_get_cfg, **overrides))
    variables = jax.tree_util.tree_map(np.asarray, det.init_variables(jax.random.PRNGKey(0)))
    model = torch_build_model(make_cfg(torch_get_cfg, **overrides), device="cpu")
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    sd = d2_state_dict(model, np.random.RandomState(3))
    pkl = tmp_path / "R-XX.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)

    params, buffers = jckpt.load_model_weights(str(pkl), variables["params"],
                                               variables["buffers"])
    want = flax_to_state_dict({"params": params, "buffers": buffers})
    tckpt.load_model_weights(str(pkl), model)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    changed = 0
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], before[k])
    # every backbone tensor was filled (FrozenBN scale and bias included),
    # the head kept its initial values
    backbone = [k for k in got if k.startswith("backbone.")]
    assert changed == len(backbone) and any(k.endswith("norm1.scale") for k in backbone)
    assert all(torch.equal(got[k], before[k]) for k in got if k.startswith("head."))
    # FrozenBN: y = x * s + b with s = w / sqrt(var + eps), b = bias - mean * s
    p = "backbone.bottom_up.res2.0.conv1.norm"
    s = sd[p + ".weight"] / np.sqrt(sd[p + ".running_var"] + 1e-5)
    np.testing.assert_array_equal(got["backbone.bottom_up.res2_0.norm1.scale"].numpy(), s)
    np.testing.assert_array_equal(got["backbone.bottom_up.res2_0.norm1.bias"].numpy(),
                                  sd[p + ".bias"] - sd[p + ".running_mean"] * s)


def test_d2_import_refuses_mismatches_and_unported_files(tmp_path):
    model = torch_build_model(make_cfg(torch_get_cfg, **TINY), device="cpu")
    with pytest.raises(ValueError, match="no weights matched"):
        tckpt.import_d2_weights({"roi_heads.box_head.fc1.weight": np.zeros((4, 4))}, model)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.import_d2_weights(
            {"backbone.bottom_up.stem.conv1.weight": np.zeros((8, 3, 7, 7), np.float32)}, model)
    with pytest.raises(ValueError, match="Unsupported"):
        tckpt.load_model_weights(str(tmp_path / "weights.npz"), model)
    # a PVT zoo file goes to the PVT import, which finds no PVT trunk in a ResNet model
    torch.save({"patch_embed1.proj.weight": torch.zeros(2)}, tmp_path / "pvt_tiny.pth")
    with pytest.raises(ValueError, match="no PVT trunk"):
        tckpt.load_model_weights(str(tmp_path / "pvt_tiny.pth"), model)
    torch.save({"other": torch.zeros(2)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="not a checkpoint"):
        tckpt.load_model_weights(str(tmp_path / "other.pth"), model)
    for name in ("stem.conv1.norm.weight", "res3.1.shortcut.weight", "fpn_output4.bias",
                 "top_block.p7.weight", "head.cls_logits.weight"):
        assert tckpt._d2_resnet_name_map("backbone." + name) == jckpt._d2_resnet_name_map(
            "backbone." + name)


# ------------------------------------------------------------------ resume
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ckpt")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    tcatalog.DatasetCatalog.remove(NAME)
    register_coco_instances(NAME, path, root)
    return tmp


def trainer_cfg(out, max_iter):
    return make_cfg(torch_get_cfg, **TINY, **{
        "MODEL.FCOS.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
        "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
        "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
        "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
        "SOLVER.IMS_PER_BATCH": 2, "SOLVER.MAX_ITER": max_iter, "SOLVER.BASE_LR": 0.01,
        "SOLVER.WARMUP_ITERS": 10, "SOLVER.STEPS": (4,), "SOLVER.CHECKPOINT_PERIOD": 100,
        "SEED": 3, "OUTPUT_DIR": str(out)})


def test_resumed_run_is_bit_equal_to_the_uninterrupted_run(synth, monkeypatch):
    """k = 2, n = 5. The loader restarts its stream from its seed on resume
    (the JAX trainer's does too), so the uninterrupted run is fed the same
    sequence: the stream's first k batches, then the stream again."""
    k, n = 2, 5
    first = ttrainer.BaseTrainer(trainer_cfg(synth / "resumed", k), device="cpu")
    first.resume_or_load(resume=False)
    first.train()
    assert (synth / "resumed" / "last_checkpoint").read_text() == f"model_{k:07d}"

    resumed = ttrainer.BaseTrainer(trainer_cfg(synth / "resumed", n), device="cpu")
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == k and resumed.train_step.count == k
    assert_states_equal(resumed.state(), first.state())     # just after resume_or_load
    resumed.train()

    real_loader = ttrainer.build_detection_train_loader

    def restarting_loader(cfg, seed=0):
        def stream():
            head = iter(real_loader(cfg, seed=seed))
            for _ in range(k):
                yield next(head)
            yield from real_loader(cfg, seed=seed)
        return stream()

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", restarting_loader)
    straight = ttrainer.BaseTrainer(trainer_cfg(synth / "straight", n), device="cpu")
    straight.resume_or_load(resume=False)
    straight.train()

    want, got = straight.state(), resumed.state()
    assert got["iteration"] == want["iteration"] == n
    assert_states_equal(got, want)
    momenta = [s["momentum_buffer"] for s in got["optimizer"]["state"].values()]
    assert sum(float(m.abs().max()) > 0 for m in momenta) > len(momenta) // 2 > 10
    # the LR went on from k: warm-up and the decay at STEPS = (4,) included
    lrs = [g["lr"] for g in got["optimizer"]["param_groups"]]
    assert lrs == [g["lr"] for g in want["optimizer"]["param_groups"]]
    assert lrs[0] == pytest.approx(resumed.train_step.schedule(n - 1))
    # and what the final checkpoints hold is equal too
    a = resumed.checkpointer.load(resumed.checkpointer.get_checkpoint_file())
    b = straight.checkpointer.load(straight.checkpointer.get_checkpoint_file())
    assert_states_equal(a, b)


def test_step_count_is_state_of_the_train_step():
    """A restored count moves the schedule: the same update from count 0
    and from count 7 differs by the warm-up's LR ratio."""
    deltas = []
    for count in (0, 7):
        cfg, model, optimizer, step = tiny_model_and_step(
            **{"SOLVER.WARMUP_ITERS": 10, "SOLVER.MOMENTUM": 0.0, "SOLVER.WEIGHT_DECAY": 0.0})
        step.count = count
        w = model.head.cls_logits.weight
        old = w.detach().clone()
        step(tiny_batch(1))
        assert step.count == count + 1
        assert all(g["lr"] == step.schedule(count) * g["lr_factor"]
                   for g in optimizer.param_groups)
        deltas.append((w.detach() - old).double())
    # float32 parameters round the small warm-up updates: 2%
    ratio = float(deltas[1].abs().sum() / deltas[0].abs().sum())
    assert ratio == pytest.approx(step.schedule(7) / step.schedule(0), rel=2e-2)
