"""The port's three probe tools held against the JAX package's Pallas probes
on the CPU (the CUDA probe kernels are checked against their plain versions
on a card by ``tests/test_torch_package.py``).

The JAX side is each tool's own kernel: the tool's ``run`` / ``run_variant``
is driven once with ``pl.pallas_call`` replaced by a recorder, which keeps
the kernel function and its call (grid, block specs, scratch, output shape)
and returns zeros; the recorded call then runs under ``interpret=True`` on
the test's input, as the JAX package's own kernel tests run on the CPU. The
tools compute in bf16, so the fused variants compare within bf16 rounding;
copies and tokens compare exactly or to float32 rounding.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from slenderobjdet_torch.ops import _build
from slenderobjdet_torch.ops.bw_probe import (bw_copy, chunk_bytes, copy_chunks,
                                              reference_copy)
from slenderobjdet_torch.ops.dma_streams_probe import (dma_streams,
                                                       reference_dma_streams)
from slenderobjdet_torch.ops.fused_bottleneck import (PROBE_MODES, probe_variant,
                                                      reference_bottleneck,
                                                      reference_probe_variant)
from slenderobjdet_torch.tools import bw_probe as t_bw
from slenderobjdet_torch.tools import dma_streams_probe as t_dma
from slenderobjdet_torch.tools import fused_kernel_probe as t_fused

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2e-2   # max |diff| / max |ref|: two bf16 programs, same rounding points


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_pallas_call(monkeypatch, drive):
    """The kernel and call arguments of the first ``pl.pallas_call`` that
    ``drive()`` makes, as a function of the call's inputs that runs the
    kernel in interpret mode."""
    seen = []

    def recorder(kernel, **kw):
        seen.append((kernel, kw))
        return lambda *args: jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), kw["out_shape"])

    with monkeypatch.context() as m:
        m.setattr(pl, "pallas_call", recorder)
        drive()
    kernel, kw = seen[0]
    return lambda *args: pl.pallas_call(kernel, interpret=True, **kw)(*args)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# ----------------------------------------------------------- fused probe
B, H, W, CIN, CM, TH = 2, 8, 8, 32, 16, 4


def _fused_inputs():
    rs = np.random.RandomState(0)
    x = _bf16(np.maximum(rs.randn(B, H, W, CIN), 0) * 0.5)
    w1 = _bf16(rs.randn(CIN, CM) * 0.2)
    w2 = _bf16(rs.randn(9, CM, CM) * 0.1)
    w3 = _bf16(rs.randn(CM, CIN) * 0.2)
    b1, b2, b3 = (rs.randn(1, n).astype(np.float32) * 0.1 for n in (CM, CM, CIN))
    return x, w1, b1, w2, b2, w3, b3


@pytest.mark.parametrize("mode", ["full", "norolls", "notap", "noconv2", "dmaonly"])
def test_fused_probe_plain_versions_match_jax_kernel(monkeypatch, mode):
    jtool = _jax_tool("fused_kernel_probe")
    call = recorded_pallas_call(
        monkeypatch, lambda: jtool.run_variant(mode, B, H, W, CIN, CM, CIN, TH,
                                               reps=1, iters=1))
    x, w1, b1, w2, b2, w3, b3 = _fused_inputs()
    nh = -(-H // TH)
    xp = np.pad(x, ((0, 0), (1, nh * TH - H + 1), (0, 0), (0, 0)))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)            # noqa: E731
    want = call(bf(xp), bf(w1), jnp.asarray(b1), bf(w2), jnp.asarray(b2), bf(w3),
                jnp.asarray(b3))
    want = np.asarray(want.astype(jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    got = reference_probe_variant(
        mode, t(x).to(torch.bfloat16), t(w1), t(b1[0]), t(w2.reshape(3, 3, CM, CM)),
        t(b2[0]), t(w3), t(b3[0])).float().numpy()
    assert got.shape == want.shape == (B, H, W, CIN)
    if mode == "dmaonly":
        np.testing.assert_array_equal(got, want)
    else:
        assert _ratio(got, want) <= BF16_TOL


def test_fused_probe_nodma_differs_from_jax_only_in_the_written_value(monkeypatch):
    """The TPU probe writes b + (row tile index), a function of its tile
    height; the port writes b + row, which any tiling can check. Both write
    every element, each a function of (image, row) alone."""
    jtool = _jax_tool("fused_kernel_probe")
    call = recorded_pallas_call(
        monkeypatch, lambda: jtool.run_variant("nodma", B, H, W, CIN, CM, CIN, TH,
                                               reps=1, iters=1))
    x, w1, b1, w2, b2, w3, b3 = _fused_inputs()
    xp = jnp.zeros((B, H + 2, W, CIN), jnp.bfloat16)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)            # noqa: E731
    want = np.asarray(call(xp, bf(w1), jnp.asarray(b1), bf(w2), jnp.asarray(b2), bf(w3),
                           jnp.asarray(b3)).astype(jnp.float32))
    rows = np.arange(H)
    np.testing.assert_array_equal(
        want, np.broadcast_to((np.arange(B)[:, None] + rows // TH)[:, :, None, None],
                              want.shape))
    got = reference_probe_variant("nodma", torch.zeros(B, H, W, CIN, dtype=torch.bfloat16),
                                  *[torch.zeros(1)] * 4, torch.zeros(CM, CIN),
                                  torch.zeros(CIN))
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.broadcast_to((np.arange(B)[:, None] + rows)[:, :, None, None], want.shape))


def test_probe_full_and_cudnn_block_are_the_bottleneck():
    """``full`` is ``reference_bottleneck``, and the tool's ``cudnn`` mode
    (three convolutions with bias) is the same block, in fp32 here."""
    x, (w1, b1, w2, b2, w3, b3) = t_fused.block_inputs(2, 9, 11, 64, 32, 64, "cpu")
    args = [x.float()] + [w.float() for w in (w1, b1, w2, b2, w3, b3)]
    want = reference_bottleneck(*args)
    assert torch.equal(reference_probe_variant("full", *args), want)
    assert _ratio(t_fused.cudnn_block(*args).numpy(), want.numpy()) <= 1e-5


def test_probe_variant_on_cpu_is_the_plain_version_and_launches_nothing():
    x, w = t_fused.block_inputs(1, 5, 6, 64, 32, 64, "cpu")
    _build.reset_launch_counts()
    for mode in PROBE_MODES:
        assert torch.equal(probe_variant(mode, x, *w), reference_probe_variant(mode, x, *w))
    assert _build.launch_counts()["fused_kernel_probe"] == 0
    with pytest.raises(ValueError):
        probe_variant("xla", x, *w)


# -------------------------------------------------------- dma streams probe
@pytest.mark.parametrize("nstreams", [1, 2, 4])
def test_dma_streams_plain_version_matches_jax_kernel(monkeypatch, nstreams):
    """The TPU kernel writes one (8, 128) block that every grid step
    overwrites: the last tile's token, the port's ``[-1, -1]``."""
    jtool = _jax_tool("dma_streams_probe")
    b, h, w, c, th = 2, 16, 8, 128, 8
    call = recorded_pallas_call(
        monkeypatch, lambda: jtool.run(nstreams, b, h, w, c, th, reps=1, iters=1))
    x = _bf16(np.random.RandomState(1).randn(b, h, w, c))
    want = np.asarray(call(jnp.asarray(x, jnp.bfloat16)))
    got = reference_dma_streams(torch.from_numpy(x).to(torch.bfloat16), th)
    assert tuple(got.shape) == (b, h // th, 8, 128)
    np.testing.assert_allclose(got[-1, -1].numpy(), want, rtol=1e-5, atol=1e-12)
    assert torch.equal(dma_streams(torch.from_numpy(x).to(torch.bfloat16), th, nstreams), got)


# ------------------------------------------------------------- bw probe
@pytest.mark.parametrize("mode", ["blocked", "chunked"])
def test_bw_copy_plain_version_matches_jax_kernel(monkeypatch, mode):
    jtool = _jax_tool("pallas_bw_probe")
    b, h, w, c, th = 2, 8, 8, 256, 4
    call = recorded_pallas_call(
        monkeypatch, lambda: jtool.run(mode, b, h, w, c, th, reps=1, iters=1))
    x = _bf16(np.random.RandomState(2).randn(b, h, w, c))
    want = np.asarray(call(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(reference_copy(xt).float().numpy(), want)
    assert torch.equal(bw_copy(xt, th, mode), reference_copy(xt))


@pytest.mark.parametrize("mode", ["blocked", "chunked"])
@pytest.mark.parametrize("th", [1, 7, 32, 200])
@pytest.mark.parametrize("batch", [1, 8])
def test_bw_copy_chunk_list_covers_every_vector_once(mode, th, batch):
    """The grid: whatever th, every 16-byte vector of x is in exactly one
    chunk, and a chunk holds whole pixels of one th-row block and is no
    larger than a CTA takes; ``chunked`` stores a chunk in 128-channel
    slices."""
    shape = (batch, 40, 12, 256)
    vectors = int(np.prod(shape)) // 8
    row, cv = 12 * 256 // 8, 256 // 8            # vectors per row and per pixel
    seen = np.zeros(vectors, np.int32)
    last = -1
    for order in copy_chunks(shape, th, mode):
        order = order.numpy()
        assert 0 < len(order) <= chunk_bytes(256) // 16 and len(order) % cv == 0
        lo, hi = order.min(), order.max()
        assert lo == last + 1 and hi - lo + 1 == len(order)   # contiguous in x, in order
        last = hi
        block = min(th, 40) * row                 # one th-row block of one image
        assert lo % (40 * row) // block == hi % (40 * row) // block
        assert lo // (40 * row) == hi // (40 * row)
        if mode == "blocked":
            np.testing.assert_array_equal(order, np.arange(lo, hi + 1))
        else:       # all pixels' first 128 channels, then their second
            half = len(order) // 2
            assert ((order[:half] - lo) % cv < 16).all()
            assert ((order[half:] - lo) % cv >= 16).all()
        seen[order] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("tool,argv", [
    (t_fused, ["--batch", "1"]),
    (t_dma, ["--batch", "1"]),
    (t_bw, ["--batch", "1"]),
])
def test_probe_tools_need_a_card(monkeypatch, tool, argv):
    """A probe measures the card or fails: no CPU timing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        tool.main(argv)

