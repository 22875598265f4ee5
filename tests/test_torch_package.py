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


def test_port_imports_no_jax():
    """Importing the port (its train step and probe tools included) and
    building the flagship model leaves jax, flax and the JAX package out of
    sys.modules (a fresh interpreter)."""
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
cfg = get_cfg()
cfg.merge_from_file({str(CONFIG)!r})
cfg.MODEL.RESNETS.DEPTH = 18
model = build_model(cfg, device="cpu")
make_train_step(model, build_optimizer(cfg, model), cfg)
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
    ("MODEL.FCOS.USE_DCN_IN_TOWER", True),
    ("TPU.PACK_HEAD_LEVELS", True),
    ("TPU.INT8_PREDICT", True),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, False, False]),
    ("MODEL.RESNETS.NORM", "GN"),
])
def test_unported_options_raise(key, value):
    with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
        build_model(_flagship(**{key: value}), device="cpu")


def test_unknown_meta_architecture_lists_available():
    cfg = _flagship(**{"MODEL.META_ARCHITECTURE": "RetinaNet"})
    with pytest.raises(KeyError, match="FCOSV2"):
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
    """The build compiles every source for sm_90a, and its cache key hashes
    the shared header too, so an edit to the header rebuilds."""
    cmd = _build.nvcc_command("lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == "lib.so"
    for src in _build.SOURCES:
        assert (_build.CSRC / src).exists()
        assert any(c.endswith(src) for c in cmd)
    assert _build.BUILD_ROOT == ROOT / "build" / "torch_kernels"
    hashed = {p.name for p in _build.hashed_files()}
    assert hashed == set(_build.SOURCES) | set(_build.HEADERS)
    for header in _build.HEADERS:
        assert not any(c.endswith(header) for c in cmd)
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
