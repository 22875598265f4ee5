"""The port's PVT / PVTv2 zoo import (``slenderobjdet_torch/checkpoint/
checkpointer.py:import_pvt_weights``) held against the JAX package's import
followed by ``checkpoint/bridge.py``, on the CPU: the same synthetic zoo
state dicts (v1 with stage 4's cls slot and the classification leaves; v2
with ``mlp.dwconv.dwconv`` and the per-stage ``norm{i}``) go into the same
drawn trunk on both sides, and the port's result must equal the bridged JAX
result (bit for bit; the position embeddings, resampled 7 x 7 from the zoo's
grids, within 1e-6 of the largest value). Also the ``.pth`` dispatch of
``load_model_weights``, the import into RetinaNet's trunk at full width, and
the files and models it refuses. No real zoo file is in the repository."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from slenderobjdet_torch.checkpoint.bridge import flax_to_state_dict  # noqa: E402
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.backbones import pvt as tpvt  # noqa: E402
from slenderobjdet_tpu.checkpoint import checkpointer as jckpt  # noqa: E402
from slenderobjdet_tpu.models.backbones import pvt as jpvt  # noqa: E402
from test_torch_pvt import (NARROW, PVT_FAMILIES, PVT_OVERRIDES, RESIZE_TOL,  # noqa: E402
                            detector_cfg, draw_tree, one_torch_thread, ratio)  # noqa: F401


def zoo_state_dict(seed, v2, dims=NARROW["dims"], depths=NARROW["depths"],
                   mlp=NARROW["mlp_ratios"], sr=NARROW["sr_ratios"]):
    """Random weights in the PVT / PVTv2 zoo's layout (``pvt_tiny``,
    ``pvt_v2_b*`` keys), classification leaves included."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    sd, cin = {}, 3
    for i, (c, d) in enumerate(zip(dims, depths), start=1):
        k = (7 if i == 1 else 3) if v2 else (4 if i == 1 else 2)
        sd[f"patch_embed{i}.proj.weight"] = r(c, cin, k, k)
        sd[f"patch_embed{i}.proj.bias"] = r(c)
        sd[f"patch_embed{i}.norm.weight"] = 1 + r(c)
        sd[f"patch_embed{i}.norm.bias"] = r(c)
        if v2:
            sd[f"norm{i}.weight"] = 1 + r(c)
            sd[f"norm{i}.bias"] = r(c)
        else:       # the zoo's 56 x 56 / 28 x 28 / ... grids; stage 4 holds the cls slot
            side = 56 >> (i - 1)
            sd[f"pos_embed{i}"] = r(1, side * side + (i == 4), c) * 10
        h = c * mlp[i - 1]
        for j in range(d):
            p = f"block{i}.{j}"
            for name, shape in (("norm1", (c,)), ("norm2", (c,)), ("attn.q", (c, c)),
                                ("attn.kv", (2 * c, c)), ("attn.proj", (c, c)),
                                ("mlp.fc1", (h, c)), ("mlp.fc2", (c, h))):
                sd[f"{p}.{name}.weight"] = r(*shape) + (1 if len(shape) == 1 else 0)
                sd[f"{p}.{name}.bias"] = r(shape[0])
            if sr[i - 1] > 1:
                sd[f"{p}.attn.sr.weight"] = r(c, c, sr[i - 1], sr[i - 1])
                sd[f"{p}.attn.sr.bias"] = r(c)
                sd[f"{p}.attn.norm.weight"] = 1 + r(c)
                sd[f"{p}.attn.norm.bias"] = r(c)
            if v2:
                sd[f"{p}.mlp.dwconv.dwconv.weight"] = r(h, 1, 3, 3)
                sd[f"{p}.mlp.dwconv.dwconv.bias"] = r(h)
        cin = c
    sd["head.weight"], sd["head.bias"] = r(1000, dims[-1]), r(1000)
    if not v2:
        sd["cls_token"], sd["norm.weight"], sd["norm.bias"] = r(1, 1, dims[-1]), r(dims[-1]), r(dims[-1])
    return sd


@pytest.mark.parametrize("v2", [False, True], ids=["pvt", "pvtv2"])
def test_import_equals_jax_import_through_the_bridge(v2, tmp_path):
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmod = (jpvt.PVTv2 if v2 else jpvt.PVT)(**NARROW)
    params = draw_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), seed=3)["params"]
    sd = zoo_state_dict(4, v2)
    want = flax_to_state_dict({"params": jckpt.import_pvt_weights(
        {k: v.numpy() for k, v in sd.items()}, params)})
    before = flax_to_state_dict({"params": params})

    model = tpvt.PVT(**NARROW, v2=v2)
    model.load_state_dict(before)
    path = str(tmp_path / "zoo.pth")
    torch.save({"model": sd}, path)            # the zoo's files nest the dict under "model"
    tckpt.load_model_weights(path, model)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.startswith("pos_embed"):
            assert ratio(got[k].numpy(), w.numpy()) <= RESIZE_TOL, k
        else:
            assert torch.equal(got[k], w), k
    # what the file fills, and what keeps its value: v1 files hold no
    # per-stage norm
    assert not torch.equal(got["stage1_block0.attn.sr_norm.weight"],
                           before["stage1_block0.attn.sr_norm.weight"])
    assert torch.equal(got["stage_norm2.weight"], before["stage_norm2.weight"]) != v2
    if v2:
        assert torch.equal(got["stage1_block0.dwconv.weight"],
                           sd["block1.0.mlp.dwconv.dwconv.weight"])
    else:
        assert got["pos_embed4"].shape == (1, 7, 7, 64)


def test_import_fills_retinanets_trunk_at_full_width():
    """The zoo's PVT-Tiny layout into RetinaNet on PVT "tiny": every trunk
    tensor under ``backbone.bottom_up.`` but the per-stage output norms (a
    v1 file has none) comes from the file; the FPN and head keep theirs."""
    cfg = detector_cfg(torch_get_cfg, {**PVT_FAMILIES["pvt"], **PVT_OVERRIDES})
    model = torch_build_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = zoo_state_dict(5, False, dims=tpvt.PVT_DIMS, depths=tpvt.PVT_DEPTHS["tiny"],
                        mlp=tpvt.PVT_MLP_RATIOS, sr=tpvt.PVT_SR_RATIOS)
    tckpt.import_pvt_weights({f"module.{k}": v for k, v in sd.items()}, model)
    after = model.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    trunk = {k for k in after if k.startswith("backbone.bottom_up.")}
    assert changed == {k for k in trunk if ".stage_norm" not in k}
    assert torch.equal(after["backbone.bottom_up.stage3_block1.attn.kv.weight"],
                       sd["block3.1.attn.kv.weight"])


def test_import_refuses_what_it_cannot_place(tmp_path):
    model = tpvt.PVT(**NARROW)
    path = str(tmp_path / "other.pth")
    torch.save({"some.layer.weight": torch.zeros(3)}, path)
    with pytest.raises(ValueError, match="PVT"):
        tckpt.load_model_weights(path, model)
    with pytest.raises(ValueError, match="no weights matched"):
        tckpt.import_pvt_weights({"patch_embed9.proj.weight": np.zeros(3)}, model)
    bad = zoo_state_dict(6, False)
    bad["block1.0.attn.q.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.import_pvt_weights(bad, model)
    with pytest.raises(ValueError, match="no PVT trunk"):
        tckpt.import_pvt_weights(zoo_state_dict(6, False), torch.nn.Linear(2, 2))
