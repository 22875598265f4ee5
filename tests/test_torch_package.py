"""Packaging and boundaries of the PyTorch port: it never imports JAX or the
JAX package, its config copy stays equal to the JAX package's, unported
options raise, the kernel build targets sm_90a, and (on a CUDA card only)
each kernel, its gradients and each probe kernel agree with the plain
versions. This file imports no jax, so its card cases run on a machine
without it (``--noconftest``)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.models import build_model
from slenderobjdet_torch.ops import _build
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
RETINA_CONFIG = ROOT / "configs/retina/retinanet_R_50_FPN_1x.yaml"
RCNN_CONFIG = ROOT / "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"
REPPOINTS_CONFIG = ROOT / "configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml"
V3_CONFIG = ROOT / "configs/fcos/fcosv3_R_50_FPN_1x.yaml"
CORNER_CONFIG = ROOT / "configs/corner/corner_net_hourglass.yaml"


def test_port_imports_no_jax():
    """Importing the port (its train step, probe tools and host-side data
    modules included) and building the flagship model, RetinaNet, Faster
    R-CNN, RepPoints, FCOSV3 and CornerNet (at DEPTH_BLOCK 2) leaves jax,
    flax and the JAX package out of sys.modules (a fresh interpreter)."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import slenderobjdet_torch
from slenderobjdet_torch.config import get_cfg
from slenderobjdet_torch.models import build_model
from slenderobjdet_torch.checkpoint import bridge
from slenderobjdet_torch.engine import make_train_step
from slenderobjdet_torch.solver import build_optimizer
from slenderobjdet_torch.tools import bw_probe, dma_streams_probe, fused_kernel_probe
from slenderobjdet_torch.models import anchors, matchers
from slenderobjdet_torch.models.meta_arch import hybrids, rcnn, reppoints, retinanet
from slenderobjdet_torch.models.meta_arch import proposal_network
from slenderobjdet_torch.models.proposal_generator import ppg, rpg
from slenderobjdet_torch.models import sampling
from slenderobjdet_torch.ops import corner_pool, deform_conv, roi_align
from slenderobjdet_torch.structures import borders, native
from slenderobjdet_torch.data import recordpack
from slenderobjdet_torch.data.datasets import objects365
from slenderobjdet_torch.utils import smart_path
from slenderobjdet_torch.tools import coco_to_pack
names = []
for config in ({str(CONFIG)!r}, {str(RETINA_CONFIG)!r}, {str(RCNN_CONFIG)!r},
               {str(REPPOINTS_CONFIG)!r}, {str(V3_CONFIG)!r}, {str(CORNER_CONFIG)!r}):
    cfg = get_cfg()
    cfg.merge_from_file(config)
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.HOURGLASS.DEPTH_BLOCK = 2
    model = build_model(cfg, device="cpu")
    make_train_step(model, build_optimizer(cfg, model), cfg)
    names.append(type(model).__name__)
assert names == ["FCOS", "RetinaNet", "ProposalVisibleRCNN", "RepPointsDetector",
                 "FCOSV3", "CornerNet"], names
borders.BorderMasks([[[0.0, 0.0, 9.0, 0.0, 9.0, 5.0]]]).masks((8, 12))
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'slenderobjdet_tpu')]
print(bad)
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_config_copy_equals_jax_config():
    want, got = jax_get_cfg(), torch_get_cfg()
    assert got.dump() == want.dump()
    want.merge_from_file(str(CONFIG))
    got.merge_from_file(str(CONFIG))
    assert got.dump() == want.dump()


def _flagship(**overrides):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    return cfg


@pytest.mark.parametrize("key,value", [
    ("TPU.PACK_HEAD_LEVELS", True),
])
def test_unported_options_raise(key, value):
    with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
        build_model(_flagship(**{key: value}), device="cpu")


def test_unknown_meta_architecture_lists_available():
    cfg = _flagship(**{"MODEL.META_ARCHITECTURE": "CenterNet"})
    with pytest.raises(KeyError, match="FCOSV2.*RetinaNet"):
        build_model(cfg, device="cpu")


def test_build_model_dtype_and_seeded_weights():
    cfg = _flagship()
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert a.dtype == torch.bfloat16
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert va.dtype == torch.float32 and torch.equal(va, vb), k
    assert float(a.head.cls_logits.bias[0].detach()) == pytest.approx(-np.log(99.0))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    assert build_model(cfg, device="cpu").dtype == torch.float32


def test_build_model_defaults_to_the_card(monkeypatch):
    """With no device named the model goes to the card: without one that is
    an error, never a model on the CPU; the CPU is taken when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(_flagship())
    model = build_model(_flagship(), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.gpu
def test_build_model_builds_on_the_card_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = build_model(_flagship())
    assert all(p.device.type == "cuda" for p in model.parameters())


def test_nvcc_command_targets_sm90a(tmp_path, monkeypatch):
    """The build compiles every source for sm_90a, one command a source
    (run together), and links the objects into the library; its cache key
    hashes the shared header too, so an edit to the header rebuilds."""
    compiles, link = _build.nvcc_commands("lib.so")
    assert len(compiles) == len(_build.SOURCES)
    objects = []
    for src, cmd in zip(_build.SOURCES, compiles):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert (_build.CSRC / src).exists()
        assert [c for c in cmd if c.endswith(".cu")] == [str(_build.CSRC / src)]
        objects.append(cmd[cmd.index("-o") + 1])
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[link.index("-o") + 1] == "lib.so"
    assert link[link.index("-o") + 2:] == objects and len(set(objects)) == len(objects)
    assert _build.BUILD_ROOT == ROOT / "build" / "torch_kernels"
    hashed = {p.name for p in _build.hashed_files()}
    assert hashed == set(_build.SOURCES) | set(_build.HEADERS)
    for header in _build.HEADERS:
        assert not any(c.endswith(header) for c in sum(compiles, link))
        users = [s for s in _build.SOURCES
                 if f'#include "{header}"' in (_build.CSRC / s).read_text()]
        assert set(users) >= {"fused_bottleneck.cu", "dma_streams_probe.cu"}
    copy = tmp_path / "csrc"
    copy.mkdir()
    for name in hashed:
        (copy / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build.library_path()
    with open(copy / _build.HEADERS[0], "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError):
        _build.require_cuda("fused_stem", x)
    with pytest.raises(TypeError):
        _build.dtype_code("fused_stem", torch.float16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_gpu(dtype):
    """Each CUDA kernel against its plain version on the card, at small
    shapes (chip_smoke.py covers the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import fused_bottleneck as fb
    from slenderobjdet_torch.ops import fused_stem as fs
    from slenderobjdet_torch.ops import nms

    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    def err(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    x = rnd(2, 48, 40, 3).to(dt)
    args = (rnd(7, 7, 3, 64, s=0.1), rnd(64).abs() + 0.5, rnd(64, s=0.1))
    assert err(fs.fused_stem(x, *args), fs.reference_stem(x, *args)) <= tol

    for cin, cm, cout, proj in ((64, 16, 64, True), (64, 32, 64, False),
                                (96, 64, 96, False), (64, 32, 128, True)):
        x = torch.relu(rnd(2, 13, 21, cin)).to(dt)
        args = (rnd(cin, cm, s=0.1), rnd(cm, s=0.1), rnd(3, 3, cm, cm, s=0.1),
                rnd(cm, s=0.1), rnd(cm, cout, s=0.1), rnd(cout, s=0.1))
        args += (rnd(cin, cout, s=0.1), rnd(cout, s=0.1)) if proj else (None, None)
        assert err(fb.fused_bottleneck(x, *args),
                   fb.reference_bottleneck(x, *args)) <= tol

    rs = np.random.RandomState(0)
    xy = rs.randint(0, 40, (3, 500, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + rs.randint(5, 30, (3, 500, 2))], 2),
                         dtype=torch.float32, device=dev)
    scores = torch.rand(3, 500, generator=g).to(dev)
    classes = torch.randint(0, 3, (3, 500), generator=g).to(dev)
    got = nms.cuda_batched_nms(boxes, scores, classes, 0.6, 50)
    want = nms.batched_nms(boxes, scores, classes, 0.6, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    # the NMS kernel at its edge shapes: one candidate, counts that are no
    # multiple of 32, max_out inside a group and above N, tied, zero and
    # negative scores, nothing or one thing valid, a crowded image whose
    # survivors run out, with and without classes (int32 and int64); one
    # counted launch a call, the rounds reported, candidates beyond the
    # kernel's limit refused
    for n, max_out, span, kind in ((1, 5, 40, "uniform"), (37, 64, 300, "uniform"),
                                   (37, 10, 40, "none_valid"), (37, 10, 40, "one_valid"),
                                   (300, 7, 200, "uniform"), (300, 100, 60, "sixteenths"),
                                   (300, 100, 60, "signed"), (2500, 100, 24, "uniform"),
                                   (4321, 100, 1200, "uniform")):
        xy = rs.randint(0, span, (3, n, 2))
        boxes = torch.tensor(np.concatenate([xy, xy + rs.randint(4, 40, (3, n, 2))], 2),
                             dtype=torch.float32, device=dev)
        sc = rs.rand(3, n)
        if kind == "sixteenths":
            sc = np.floor(sc * 17) / 16
        elif kind == "signed":
            sc = np.round(sc * 16 - 8) / 8 * rs.choice([1.0, 0.0, -0.0, 1e-40], (3, n))
        scores = torch.tensor(sc, dtype=torch.float32, device=dev)
        valid = rs.rand(3, n) < {"none_valid": 0.0, "uniform": 0.7}.get(kind, 0.9)
        if kind == "one_valid":
            valid[:] = False
            valid[np.arange(3), rs.randint(0, n, 3)] = True
        valid = torch.tensor(valid, device=dev)
        classes = torch.tensor(rs.randint(0, 3, (3, n)), device=dev)
        for cls in (None, classes, classes.to(torch.int32)):
            for vl in (None, valid):
                _build.reset_launch_counts()
                if cls is None:
                    got = nms.cuda_nms(boxes, scores, 0.5, max_out, vl)
                    want = nms.nms_select(boxes, scores, 0.5, max_out, vl)
                else:
                    got = nms.cuda_batched_nms(boxes, scores, cls, 0.5, max_out, vl)
                    want = nms.batched_nms(boxes, scores, cls, 0.5, max_out, vl)
                assert _build.launch_counts()["nms"] == 1
                assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, kind)
        rounds = torch.zeros(3, dtype=torch.int32, device=dev)
        got = nms.launch_nms(boxes, scores, classes, valid, 0.5, max_out, rounds=rounds)
        kept = got[1].sum(1)
        assert bool((rounds <= kept.clamp(min=0)).all()) and bool((rounds * 32 >= kept).all())
    with pytest.raises(ValueError, match="shared memory"):
        nms.cuda_nms(torch.zeros(1, 8193, 4, device=dev), torch.zeros(1, 8193, device=dev), 0.5, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cm,cout,proj,hw", [
    (64, 64, 256, True, (9, 13)),
    (256, 64, 256, False, (5, 11)),
    (128, 128, 128, False, (9, 13)),
    (256, 128, 512, True, (5, 7)),
    (256, 256, 256, False, (11, 6)),
    (512, 256, 1024, True, (3, 17)),
    (512, 512, 512, False, (3, 4)),
    (1024, 512, 2048, True, (7, 9)),
])
def test_wgmma_bottleneck_matches_plain_on_gpu(cin, cm, cout, proj, hw):
    """The bf16 wgmma path (Cm = 64, 128, 256, 512) at small ragged shapes,
    with and without a projection shortcut, against the plain version within
    the bf16 ratio 3e-2, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import fused_bottleneck as fb

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(cin + cm + cout)

    def t(*shape, s=1.0):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * s, device=dev)

    x = torch.relu(t(2, *hw, cin)).to(torch.bfloat16)
    args = (t(cin, cm, s=cin ** -0.5), t(cm, s=0.1), t(3, 3, cm, cm, s=(9 * cm) ** -0.5),
            t(cm, s=0.1), t(cm, cout, s=cm ** -0.5), t(cout, s=0.1))
    args += (t(cin, cout, s=cin ** -0.5), t(cout, s=0.1)) if proj else (None, None)
    assert fb.bottleneck_plan(x.dtype, 2, *hw, cin, cm, cout)["route"] == "wgmma"
    _build.reset_launch_counts()
    got = fb.fused_bottleneck(x, *args)
    want = fb.reference_bottleneck(x, *args)
    assert _build.launch_counts()["fused_bottleneck"] == 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
    assert err <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("batch,hw", [(1, (800, 1344)), (3, (64, 128)),
                                      (1, (36, 52)), (3, (36, 52)), (3, (4, 4))])
def test_stem_kernels_match_plain_on_gpu(batch, hw):
    """The stem on the card at full and ragged sizes (H, W divisible by 4,
    not by the tile): bf16 with 64 channels takes the tensor-core kernel and
    agrees with the plain version within the bf16 ratio 3e-2; bf16 at 16
    channels and float32 take the CUDA-core kernel (float32 within 1e-4);
    one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import fused_stem as fs

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(batch + hw[0])

    def t(*shape, s=1.0):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * s, device=dev)

    x = t(batch, *hw, 3, s=50.0)
    for dt, cs, route, tol in ((torch.bfloat16, 64, "mma", 3e-2),
                               (torch.bfloat16, 16, "cuda_cores", 3e-2),
                               (torch.float32, 64, "cuda_cores", 1e-4)):
        args = (t(7, 7, 3, cs, s=147 ** -0.5), t(cs).abs() * 0.5 + 0.75, t(cs, s=0.1))
        assert fs.stem_plan(dt, batch, *hw, cs)["route"] == route
        _build.reset_launch_counts()
        got = fs.fused_stem(x.to(dt), *args)
        want = fs.reference_stem(x.to(dt), *args)
        assert _build.launch_counts()["fused_stem"] == 1
        assert got.shape == want.shape == (batch, hw[0] // 4, hw[1] // 4, cs)
        assert got.dtype == dt
        err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
        assert err <= tol, (dt, cs, err)


@pytest.mark.gpu
@pytest.mark.parametrize("th", [1, 7, 32, 200])
def test_bw_copy_is_bit_exact_on_gpu(th):
    """The copy probe's grid of chunks at the tool's shape (one image) and
    at a small ragged one: both modes equal ``x * 0.5`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops.bw_probe import bw_copy, reference_copy

    g = torch.Generator(device="cuda").manual_seed(th)
    for shape in ((1, 200, 336, 256), (3, 37, 5, 72)):
        x = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
        for mode in ("blocked", "chunked"):
            _build.reset_launch_counts()
            assert torch.equal(bw_copy(x, th, mode), reference_copy(x)), (shape, mode)
            assert _build.launch_counts()["bw_probe"] == 1


@pytest.mark.gpu
def test_fused_autograd_kernel_gradients_match_plain_on_gpu():
    """On the card: gradients through the CUDA kernels at a res4-shaped
    block (and the stem) are non-zero and match the plain versions' within
    the bf16 tolerance of the forward checks (3e-2 of the max)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.ops.fused_bottleneck import (fused_bottleneck,
                                                          reference_bottleneck)
    from slenderobjdet_torch.ops.fused_stem import fused_stem, reference_stem

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(11)

    def t(*shape, s=1.0):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * s, device=dev)

    x = torch.relu(t(2, 50, 84, 1024)).to(torch.bfloat16)
    ws = [t(1024, 256, s=1 / 32), t(256, s=0.1), t(3, 3, 256, 256, s=1 / 48), t(256, s=0.1),
          t(256, 1024, s=1 / 16), t(1024, s=0.1)]
    g = t(2, 50, 84, 1024).to(torch.bfloat16)
    grads = []
    for fn in (fused_bottleneck, reference_bottleneck):
        xl = x.clone().requires_grad_()
        wl = [w.clone().requires_grad_() for w in ws]
        _build.reset_launch_counts()
        fn(xl, *[w.to(torch.bfloat16) if w.dim() > 1 else w for w in wl]).backward(g)
        grads.append([xl.grad] + [w.grad for w in wl])
        if fn is fused_bottleneck:
            assert _build.launch_counts()["fused_bottleneck"] == 1
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        assert float((a.double() - b.double()).abs().max() / b.double().abs().max()) <= 3e-2

    xs = (t(2, 64, 96, 3) * 50).to(torch.bfloat16)
    w, scale, bias = t(7, 7, 3, 64, s=0.1), t(64).abs() + 0.5, t(64, s=0.1)
    sg = []
    for fn in (fused_stem, reference_stem):
        wl = w.clone().requires_grad_()
        fn(xs, wl, scale, bias).float().square().sum().backward()
        sg.append(wl.grad)
    assert float(sg[0].abs().max()) > 0
    assert float((sg[0] - sg[1]).abs().max() / sg[1].abs().max()) <= 3e-2


@pytest.mark.gpu
def test_probe_kernels_match_plain_on_gpu():
    """Each probe kernel against its plain version on the card at small
    shapes (chip_smoke.py covers the R-50 shapes): every fused variant
    within the bf16 tolerance and ``full`` bit-exact with the model's
    kernel, the DMA tokens to float32 rounding, the copies bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops.bw_probe import bw_copy, reference_copy
    from slenderobjdet_torch.ops.dma_streams_probe import (dma_streams,
                                                           reference_dma_streams)
    from slenderobjdet_torch.ops.fused_bottleneck import (PROBE_MODES,
                                                          fused_bottleneck,
                                                          probe_variant,
                                                          reference_probe_variant)
    from slenderobjdet_torch.tools.fused_kernel_probe import block_inputs

    def ratio(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    dev = torch.device("cuda")
    for cin, cm, hw in ((128, 64, (13, 21)), (256, 128, (16, 24))):
        x, w = block_inputs(2, *hw, cin, cm, cin, dev, seed=3)
        main = fused_bottleneck(x, *w)
        for mode in PROBE_MODES:
            got = probe_variant(mode, x, *w)
            want = reference_probe_variant(mode, x, *w)
            assert ratio(got, want) <= 3e-2, mode
            if mode == "full":
                assert torch.equal(got, main)
    x = torch.randn(2, 40, 24, 256, device=dev).to(torch.bfloat16)
    for th, n in ((8, 1), (16, 3), (40, 8)):
        got, want = dma_streams(x, th, n), reference_dma_streams(x, th)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-12)
    for mode in ("blocked", "chunked"):
        for th in (1, 7, 40):
            assert torch.equal(bw_copy(x, th, mode), reference_copy(x))


@pytest.mark.gpu
def test_rpn_level_nms_matches_plain_on_gpu():
    """The RPN's level-aware NMS (``level_batched_nms``: one kernel launch
    over rows of (image, level), then the merge) equals the plain
    ``batched_nms`` with the level as the class, bit for bit, at the RPN's
    training shape at 896 x 1408 (2000 x 4 + 924 = 8,924 candidates, 1,000
    slots) and its predict shape (4,924), on integer-pixel boxes with tied
    scores; a row beyond the kernel's limit raises instead of taking the
    plain loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import nms

    dev = torch.device("cuda")
    rs = np.random.RandomState(8)
    for counts in ([2000] * 4 + [924], [1000] * 4 + [924]):
        n = sum(counts)
        xy = rs.randint(0, 1408, (2, n, 2))
        boxes = np.clip(np.concatenate([xy, xy + rs.randint(2, 350, (2, n, 2))], 2), 0, 1408)
        boxes = torch.tensor(boxes, dtype=torch.float32, device=dev)
        scores = torch.tensor(np.floor(rs.rand(2, n) * 64) / 64, dtype=torch.float32, device=dev)
        valid = torch.tensor(rs.rand(2, n) < 0.9, device=dev)
        levels = torch.cat([torch.full((c,), i, device=dev) for i, c in enumerate(counts)])
        _build.reset_launch_counts()
        rounds = torch.zeros(2 * len(counts), dtype=torch.int32, device=dev)
        got = nms.level_batched_nms(boxes, scores, counts, 0.7, 1000, valid=valid,
                                    rounds=rounds)
        assert _build.launch_counts()["nms"] == 1
        want = nms.batched_nms(boxes, scores, levels.expand(2, -1), 0.7, 1000, valid=valid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), counts
        assert int(got[1].sum(1).min()) == 1000 and int(rounds.min()) >= 1
    with pytest.raises(ValueError, match="shared memory"):
        nms.level_batched_nms(torch.zeros(1, 9000, 4, device=dev),
                              torch.zeros(1, 9000, device=dev), [8193, 807], 0.7, 1000)
    with pytest.raises(ValueError, match="shared memory"):
        nms.cuda_batched_nms(torch.zeros(1, 8924, 4, device=dev), torch.zeros(1, 8924, device=dev),
                             torch.zeros(1, 8924, dtype=torch.int32, device=dev), 0.7, 1000)


@pytest.mark.gpu
def test_deform_op_bf16_matches_fp32_on_gpu():
    """The deformable conv on the card: bf16 forward and its feature, offset
    and weight gradients against the same op in float32 on the same inputs,
    within 3e-2 of the float32 result's max abs value; offsets fractional,
    some samples outside the map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slenderobjdet_torch.ops import deform_conv as dc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(9)
    x = torch.tensor(rs.randn(2, 20, 28, 64), dtype=torch.float32, device=dev)
    off = torch.tensor(dc.kernel_base_offsets(3) + rs.randn(2, 20, 28, 9, 2) * 2.0,
                       dtype=torch.float32, device=dev)
    w = torch.tensor(rs.randn(9, 64, 32) * 0.05, dtype=torch.float32, device=dev)
    g = torch.tensor(rs.randn(2, 20, 28, 32), dtype=torch.float32, device=dev)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xs = x.to(dt).detach().requires_grad_(True)
        offs = off.clone().requires_grad_(True)
        ws = w.clone().requires_grad_(True)
        y = dc.deform_conv2d_batched(xs, offs, ws, row_chunk=4096)
        (y.float() * g).sum().backward()
        out[dt] = [t.float() for t in (y, xs.grad, offs.grad, ws.grad)]
    for name, a, b in zip(("out", "feat", "offsets", "weight"), out[torch.bfloat16],
                          out[torch.float32]):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 3e-2, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("modulated", [False, True])
def test_dfconv2d_at_zero_offsets_matches_cudnn_on_gpu(modulated):
    """A zero ``offset_conv`` samples the kernel grid: v1 equals the cuDNN 3x3
    conv with the same weights, v2 half of it, within 1e-4 in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slenderobjdet_torch.models.layers import DFConv2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    layer = DFConv2d(64, 48, modulated=modulated).to(dev)
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.05)
    x = torch.randn(2, 64, 24, 36, device=dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = layer(x)
        w = layer.weight.permute(2, 1, 0).reshape(48, 64, 3, 3)
        want = torch.nn.functional.conv2d(x, w, layer.bias, padding=1)
    scale = 0.5 if modulated else 1.0
    err = float((got - want * scale).abs().max() / want.abs().max())
    assert err <= 1e-4, err


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["RepPointsDetector", "RepPointsCenterness", "RepPointsV2",
                                  "FCOSRepPoints", "ReppointsRetinaNet",
                                  "DeformableConvRetinaNet"])
def test_reppoints_family_builds_on_the_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(REPPOINTS_CONFIG))
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.RESNETS.DEPTH = 18
    model = build_model(cfg)
    assert type(model).__name__ == arch
    assert all(p.device.type == "cuda" for p in model.parameters())
    batch = {"image": np.zeros((1, 64, 96, 3), np.uint8), "scale": np.ones(1, np.float32),
             "orig_size": np.array([[64, 96]], np.float32)}
    out = model.predict(batch)
    assert out["boxes"].shape == (1, 100, 4) and bool(torch.isfinite(out["boxes"]).all())


@pytest.mark.gpu
def test_batchnorm_on_the_card_matches_the_cpu():
    """A trainable BatchNorm with batch statistics (outputs, running
    statistics, gradients) and with running statistics, fp32 on the card
    against the same module on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slenderobjdet_torch.models.layers import BatchNorm, batch_statistics

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 32, 12, 20, generator=gen) * 3 + 1
    g = torch.randn(4, 32, 12, 20, generator=gen)
    outs = []
    for dev in ("cpu", "cuda"):
        bn = BatchNorm(32).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 32))
            bn.bias.copy_(torch.linspace(-1, 1, 32))
        xs = x.to(dev, copy=True).requires_grad_(True)   # a leaf on each device
        with batch_statistics():
            y = bn(xs)
        (y * g.to(dev)).sum().backward()
        with torch.no_grad():
            y_eval = bn(x.to(dev))
        outs.append([t.detach().cpu() for t in (y, xs.grad, bn.weight.grad, bn.running_mean,
                                                 bn.running_var, y_eval)])
    # the two devices sum in other orders: max |diff| over the largest value
    names = ("y", "x grad", "weight grad", "running mean", "running var", "y eval")
    for name, got, want in zip(names, outs[1], outs[0]):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("generator", ["RepPointsGenerator", "PointsProposalGenerator", "RPN"])
def test_proposal_network_predicts_on_the_card(generator):
    """The three proposal networks built on the card (R-18) predict through
    the NMS kernel, one launch a call, and match the same weights on the
    CPU: the same valid slots, boxes within 1e-3 px."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.META_ARCHITECTURE = "ProposalNetwork"
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = generator
    cfg.MODEL.RPN.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rs = np.random.RandomState(3)
    batch = {"image": rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
             "scale": np.ones(2, np.float32), "orig_size": np.array([[64, 96]] * 2, np.float32)}
    _build.reset_launch_counts()
    out = model.predict(batch)
    torch.cuda.synchronize()
    assert _build.launch_counts()["nms"] == 1
    want = cpu.predict(batch)
    assert out["boxes"].shape == (2, 100, 4) and bool(torch.isfinite(out["boxes"]).all())
    assert torch.equal(out["valid"].cpu(), want["valid"])
    v = want["valid"]
    torch.testing.assert_close(out["boxes"].cpu()[v], want["boxes"][v], rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_fcosv3_loss_on_the_card_matches_the_cpu():
    """FCOSV3 (R-18, fp32, TF32 off) on the card against the same weights on
    the CPU: the gate's labels exactly (``num_pos``), each loss term within
    1e-4, on a centre map rendered from polygons (``structures/borders.py``)
    that removes positives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slenderobjdet_torch.structures.borders import BorderMasks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(V3_CONFIG))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rs = np.random.RandomState(5)
    xy = rs.randint(0, 40, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rs.randint(8, 24, (2, 6, 2))], -1).astype(np.float32)
    masks = np.stack([BorderMasks([[np.array([b[0], b[1], b[2], b[1], b[2], b[3], b[0], b[3]],
                                             np.float64)] for b in img]).center_masks((64, 64))
                      for img in boxes])
    batch = {"image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8), "gt_boxes": boxes,
             "gt_classes": rs.randint(0, 80, (2, 6)).astype(np.int32),
             "gt_valid": np.ones((2, 6), bool), "center_mask": masks}
    with torch.no_grad():
        got = model.loss(batch)[1]
        want = cpu.loss(batch)[1]
        ungated = cpu.loss({k: v for k, v in batch.items() if k != "center_mask"})[1]
    assert float(got["num_pos"]) == float(want["num_pos"]) < float(ungated["num_pos"])
    for k in ("cls_loss", "reg_loss", "centerness_loss"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k


@pytest.mark.gpu
@pytest.mark.parametrize("classes,n,max_out,thr,bsz", [
    (0, 3000, 100, 0.5, 2), (80, 5000, 100, 0.5, 2), (5, 10000, 1000, 0.7, 2),
    (5, 10000, 1000, 0.7, 16),      # the RRPN's train call: five levels
    (5, 16384, 1000, 0.7, 2)])      # the most candidates an image the sort takes
def test_rotated_kernels_match_plain_on_gpu(classes, n, max_out, thr, bsz):
    """The rotated IoU kernel (one wrapper call) against the plain IoU on
    the card, bit for bit, on boxes at 896 x 1408 and on pairs placed within
    a few margins of touching at the class offsets' coordinates (the pairs
    the kernels skip by ``extents_apart`` and their neighbours); and the
    rotated NMS kernels (one wrapper call) against the plain greedy loop:
    identical keep lists, with the models' class / level offsets (4096 x
    group), at RotatedRetinaNet's 5,000 candidates, the RRPN's 10,000 with
    1,000 slots (B = 2 and the train call's B = 16) and 16,384; integer-pixel
    boxes, angles from a small set, tied scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import rotated

    dev = torch.device("cuda")
    rs = np.random.RandomState(9 + n + (bsz - 2))           # B = 2: the seed of before
    near_rs = np.random.RandomState(7 + n + bsz)            # the near-touching pairs' draws
    angles = np.array([-90, -45, -30, 0, 15, 30, 45, 60, 90, 120], np.float32)

    def rboxes(shape, rs=rs):
        return torch.tensor(np.stack(
            [rs.randint(0, 1408, shape), rs.randint(0, 896, shape), rs.randint(4, 300, shape),
             rs.randint(4, 120, shape), rs.choice(angles, shape)], -1).astype(np.float32),
            device=dev)

    gt, anchors = rboxes((100,)), rboxes((20000,))
    gt[90:] = 0.0                                          # padded gt: zero boxes
    _build.reset_launch_counts()
    got = rotated.launch_rotated_iou(gt, anchors)
    assert _build.launch_counts()["rotated_iou"] == 1
    want = rotated.plain_pairwise_rotated_iou(gt, anchors)
    assert torch.equal(got, want) and int((want > 0).sum()) > 1000

    # 200 boxes around each of 100 at class offsets, each moved from its
    # centre along a random direction until the extents' gap is -4 to 4
    # margins (2^-17 x the largest |coordinate|)
    base = rboxes((100,), near_rs)
    base[:, :2] += torch.tensor(near_rs.randint(0, 81, (100, 1)) * 4096.0,
                                dtype=torch.float32, device=dev)
    near = rboxes((100, 200), near_rs)
    near[..., 4] = torch.tensor(near_rs.uniform(-180, 180, (100, 200)), dtype=torch.float32,
                                device=dev)
    near[..., :2] = base[:, None, :2]
    ext = lambda b: rotated.box_extents(rotated.rotated_to_corners(b))[0].double()
    e1, e2 = ext(base)[:, None], ext(near)
    span = torch.stack([e1[..., 1] - e1[..., 0] + e2[..., 1] - e2[..., 0],
                        e1[..., 3] - e1[..., 2] + e2[..., 3] - e2[..., 2]], -1) / 2
    margin = 2.0 ** -17 * torch.maximum(e1.abs().amax(-1), e2.abs().amax(-1))
    theta = torch.tensor(near_rs.uniform(0, 2 * np.pi, (100, 200)), device=dev)
    u = torch.stack([theta.cos(), theta.sin()], -1)
    gap = torch.tensor(near_rs.uniform(-4, 4, (100, 200)), device=dev) * margin
    dist = ((span + gap[..., None]) / u.abs()).amin(-1)
    near[..., :2] = (base[:, None, :2].double() + dist[..., None] * u).float()
    near = near.reshape(-1, 5)
    got = rotated.launch_rotated_iou(base, near)
    want = rotated.plain_pairwise_rotated_iou(base, near)
    skipped = rotated.extents_apart(rotated.rotated_to_corners(base)[:, None],
                                    rotated.rotated_to_corners(near)[None])
    own = skipped.view(100, 100, 200).diagonal(0, 0, 1)    # each box's own neighbours
    assert torch.equal(got, want)
    assert int(own.sum()) > 100 * 60 and int((want > 0).sum()) > 1000

    boxes, scores = rboxes((bsz, n)), torch.tensor(
        np.floor(rs.rand(bsz, n) * 64) / 64, dtype=torch.float32, device=dev)
    valid = torch.tensor(rs.rand(bsz, n) < 0.9, device=dev)
    if classes:
        groups = torch.tensor(rs.randint(0, classes, (bsz, n)), device=dev)
        boxes = rotated.offset_boxes(boxes, groups)
    _build.reset_launch_counts()
    got = rotated.rotated_nms(boxes, scores, thr, max_out, valid=valid)
    assert _build.launch_counts()["rotated_nms"] == 1
    want = rotated.plain_rotated_nms(boxes, scores, thr, max_out, valid=valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum(1).min()) >= min(max_out, 50)


@pytest.mark.gpu
def test_rotated_nms_crosses_windows_on_gpu():
    """The rotated NMS kernels against the plain greedy loop where the walk
    must go past its first window of sorted positions (2 max_out rounded
    up to 64, at most 2,048) and end before max_out: 250 clusters of 20
    near-identical boxes, 1,000 slots, thr 0.3. 200 clusters have their
    head among the highest scores and members over the whole score range,
    so that the first window's kept boxes remove positions in later
    windows; 50 have only low scores, so that boxes are kept past the first
    window. Identical keep lists, the slots past the last kept box 0 /
    invalid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from slenderobjdet_torch.ops import rotated

    dev = torch.device("cuda")
    rs = np.random.RandomState(23)
    bsz, clusters, size, max_out, thr = 2, 250, 20, 1000, 0.3
    n = clusters * size
    cell = np.stack(np.meshgrid(np.arange(25), np.arange(10)), -1).reshape(-1, 2) * 200.0 + 100
    centre = np.repeat(np.broadcast_to(cell, (bsz, clusters, 2)), size, axis=1)
    shape = np.repeat(np.stack([rs.uniform(40, 100, (bsz, clusters)),
                                rs.uniform(40, 100, (bsz, clusters)),
                                rs.uniform(-90, 90, (bsz, clusters))], -1), size, axis=1)
    boxes = np.concatenate([centre + rs.uniform(-1, 1, (bsz, n, 2)),
                            shape[..., :2] + rs.uniform(-1, 1, (bsz, n, 2)),
                            shape[..., 2:] + rs.uniform(-2, 2, (bsz, n, 1))], -1)
    member = np.arange(n) % size
    cluster = np.arange(n) // size
    scores = rs.uniform(0, 0.9, (bsz, n))
    scores[:, member == 0] = rs.uniform(0.9, 1.0, (bsz, clusters))
    low = cluster >= 200
    scores[:, low] = rs.uniform(0, 0.3, (bsz, int(low.sum())))
    boxes = torch.tensor(boxes.astype(np.float32), device=dev)
    scores = torch.tensor(scores.astype(np.float32), device=dev)
    valid = torch.tensor(rs.rand(bsz, n) < 0.95, device=dev)
    _build.reset_launch_counts()
    got = rotated.rotated_nms(boxes, scores, thr, max_out, valid=valid)
    assert _build.launch_counts()["rotated_nms"] == 1
    want = rotated.plain_rotated_nms(boxes, scores, thr, max_out, valid=valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kept = want[1].sum(1)
    assert int(kept.max()) < max_out and int(kept.min()) >= 200
    live = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(live, dim=1, descending=True, stable=True).indices
    for b in range(bsz):
        pos = torch.empty_like(order[b])
        pos[order[b]] = torch.arange(n, device=dev)
        last = int(pos[want[0][b, int(kept[b]) - 1].long()])
        assert last >= 2048, last


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner", ["tl", "br"])
@pytest.mark.parametrize("shape", [(2, 24, 19, 27), (1, 128, 28, 44), (3, 40, 37, 301),
                                   (1, 128, 224, 352), (2, 13, 21, 45)])
def test_corner_pool_kernel_matches_plain_on_gpu(shape, corner, dtype):
    """The corner-pool kernel (one wrapper call forward, one backward)
    against the plain ``torch.cummax`` composition on the card: the forward
    bit for bit on ReLU outputs (ties at zero) and on integers (ties
    anywhere); the gradients, through the ``autograd.Function``, on inputs
    without ties (a permutation of integers along each scanned line, exact
    in bf16 up to 256; a wider line rounds to ties, which both sides give
    the later element), so that no tie rule decides, against the plain
    version's autograd in fp32 on the same values, with the same support:
    fp32 within 1e-4 of the largest; bf16 within one bf16 rounding of each
    value (the kernel sums in fp32 and rounds once; the plain version's
    bf16 autograd rounds every addition and lies a few hundredths of the
    largest from fp32 at the heads' shapes, ``chip_smoke.py``); then NaN
    (1% of a and b), taken when met: the forward's NaNs where the plain
    version's are and every other value equal, the gradients as above but
    against the plain autograd in fp64 (after a NaN a line credits one
    element with hundreds of terms, and where they cancel the plain fp32
    autograd's atomic sums land on 0 in some runs and not in others).
    (3, 40, 37, 301) has a C that bf16's 16-channel chunks do not divide, a
    W that no segment or vector width divides and bf16 lines wider than
    256; (1, 128, 224, 352) is one image of the heads' width; (2, 13, 21,
    45) has an odd C, which the kernels take one element at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from slenderobjdet_torch.ops import corner_pool as cp

    dev = torch.device("cuda")
    B, C, H, W = shape
    gen = torch.Generator().manual_seed(11 + C)
    plain = cp.plain_tl_pool if corner == "tl" else cp.plain_br_pool
    pool = cp.tl_pool if corner == "tl" else cp.br_pool

    def on_card(t):
        return t.to(dtype).to(dev).contiguous(memory_format=torch.channels_last)

    for a, b in ((torch.relu(torch.randn(shape, generator=gen)),
                  torch.relu(torch.randn(shape, generator=gen))),
                 (torch.randint(0, 8, shape, generator=gen).float(),
                  torch.randint(0, 8, shape, generator=gen).float())):
        a, b = on_card(a), on_card(b)
        _build.reset_launch_counts()
        got = pool(a, b)
        assert _build.launch_counts()["corner_pool"] == 1
        assert got.dtype == dtype and torch.equal(got, plain(a, b))

    # no ties: a is a permutation of 0..H-1 down each column, b of 0..W-1
    # along each row
    a = torch.argsort(torch.rand(B, C, W, H, generator=gen), -1).transpose(2, 3).float()
    b = torch.argsort(torch.rand(B, C, H, W, generator=gen), -1).float()
    g = on_card(torch.randn(shape, generator=gen))

    def check_gradients(a, b, ref=torch.float32):
        grads = []
        for fn, cast in ((pool, on_card), (plain, lambda t: on_card(t).to(ref))):
            ta, tb = cast(a).requires_grad_(), cast(b).requires_grad_()
            _build.reset_launch_counts()
            (fn(ta, tb) * g.to(ta.dtype)).sum().backward()
            grads.append((ta.grad, tb.grad))
            if fn is pool:
                assert _build.launch_counts()["corner_pool"] == 2
        for got, want in zip(*grads):
            assert got.dtype == dtype and torch.equal(got != 0, want != 0)
            diff = (got.float() - want).abs()
            if dtype == torch.float32:
                assert float(diff.max() / want.abs().max()) <= 1e-4
            else:
                assert bool((diff <= 2 ** -8 * want.abs() + 1e-6 * want.abs().max()).all())

    check_gradients(a, b)
    a, b = (torch.relu(torch.randn(shape, generator=gen)) for _ in range(2))
    for t in (a, b):
        t[torch.rand(shape, generator=gen) < 0.01] = float("nan")
    got, want = pool(on_card(a), on_card(b)), plain(on_card(a), on_card(b))
    assert bool(got.isnan().any()) and torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    check_gradients(a, b, torch.float64)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8_weights"])
def test_exported_flagship_reloads_and_launches_the_kernels_on_gpu(tmp_path, quantize):
    """The bf16 flagship with the fused flags on, exported at B = 2, 128 x
    192 (``serving.export_detector``) and reloaded: the same launches as the
    live model (1 NMS, 1 stem, 13 bottleneck wrappers), the outputs bit-equal
    (float weights) or within the export tool's ``--verify`` tolerances
    (int8 weights, the classifier at the focal prior)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slenderobjdet_torch import serving
    from slenderobjdet_torch.tools.export_serving import verify_outputs

    model = build_model(_flagship(**{"MODEL.RESNETS.DEPTH": 50, "MODEL.RESNETS.FUSED_STEM": True,
                                     "MODEL.RESNETS.FUSED_BLOCKS": True}))
    serving.export_detector(model, str(tmp_path / "a"), batch_size=2, image_hw=(128, 192),
                            quantize=quantize)
    predict_fn = serving.load_detector(str(tmp_path / "a"))
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (2, 128, 192, 3)).astype(np.uint8),
             "scale": np.ones(2, np.float32), "orig_size": np.array([[128, 192]] * 2, np.float32)}
    counts, outs = [], []
    for fn in (model.predict, predict_fn):
        _build.reset_launch_counts()
        outs.append(fn(batch))
        torch.cuda.synchronize()
        counts.append({k: v for k, v in _build.launch_counts().items() if v})
    want, out = outs
    assert counts[0] == counts[1] == {"nms": 1, "fused_stem": 1, "fused_bottleneck": 13}
    if quantize:
        verify_outputs(out, want, quantize=True)
    else:
        for k in want:
            assert torch.equal(out[k], want[k]), k


@pytest.mark.gpu
def test_int8_predict_runs_on_gpu():
    """The flagship (bf16, flags off) under ``TPU.INT8_PREDICT``: dynamic
    int8 through ``torch._int_mm`` on the card, finite, different from bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = build_model(_flagship(**{"MODEL.RESNETS.DEPTH": 50, "TPU.INT8_PREDICT": True}))
    batch = {"image": np.random.RandomState(1).randint(0, 256, (2, 128, 192, 3)).astype(np.uint8),
             "scale": np.ones(2, np.float32), "orig_size": np.array([[128, 192]] * 2, np.float32)}
    out = model.predict(batch)
    model.int8_predict = False
    ref = model.predict(batch)
    assert bool(torch.isfinite(out["boxes"]).all()) and out["boxes"].shape == (2, 100, 4)
    assert not torch.equal(out["boxes"], ref["boxes"])
