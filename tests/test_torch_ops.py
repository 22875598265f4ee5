"""The PyTorch port's ops and kernels' plain versions held against the JAX
package on the CPU: NMS (exact indices, integer-pixel boxes), pair top-k
(exact, distinct values), the fused stem's and bottleneck's plain versions
(max abs error / max abs value <= 2e-5 in float32, as the JAX kernels' own
tests), FCOS locations and box decoding (exact). On CPU tensors each kernel
wrapper must take its plain version and count no launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.models import anchors as t_anchors
from slenderobjdet_torch.ops import _build
from slenderobjdet_torch.ops import fused_bottleneck as t_fb
from slenderobjdet_torch.ops import fused_stem as t_fs
from slenderobjdet_torch.ops import nms as t_nms
from slenderobjdet_torch.ops.topk import pair_top_k
from slenderobjdet_torch.structures import boxes as t_boxes
from slenderobjdet_tpu.models import anchors as j_anchors
from slenderobjdet_tpu.ops import fused_bottleneck as j_fb
from slenderobjdet_tpu.ops import fused_stem as j_fs
from slenderobjdet_tpu.ops import nms as j_nms
from slenderobjdet_tpu.ops import topk as j_topk
from slenderobjdet_tpu.ops.pallas_nms import pallas_nms
from slenderobjdet_tpu.structures import boxes as j_boxes

KERNEL_TOL = 2e-5


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)


def _int_boxes(rs, B, N, span, lo, hi):
    """Integer-pixel boxes: every IoU is computed from exact coordinates, the
    regime where two programs' greedy decisions are comparable bit for bit."""
    xy = rs.randint(0, span, (B, N, 2))
    wh = rs.randint(lo, hi, (B, N, 2))
    return np.concatenate([xy, xy + wh], 2).astype(np.float32)


@pytest.fixture
def no_launches():
    _build.reset_launch_counts()
    yield
    assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)


@pytest.mark.parametrize("span,with_valid", [(20, False), (20, True), (300, True)])
def test_nms_select_matches_jax(span, with_valid, no_launches):
    rs = np.random.RandomState(span + with_valid)
    B, N, K = 3, 256, 100
    boxes = _int_boxes(rs, B, N, span, 20 if span == 20 else 4, 40)
    scores = rs.permutation(B * N).reshape(B, N).astype(np.float32) / (B * N)
    valid = rs.rand(B, N) > 0.3 if with_valid else None
    tv = None if valid is None else torch.from_numpy(valid)
    ki, kv = t_nms.nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                              0.5, K, valid=tv)
    ci, cv = t_nms.cuda_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            0.5, K, valid=tv)
    pi, pv = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, K,
                        valid=None if valid is None else jnp.asarray(valid),
                        interpret=True)
    for b in range(B):
        ri, rv = j_nms.nms_select(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                  0.5, K,
                                  valid=None if valid is None else jnp.asarray(valid[b]))
        np.testing.assert_array_equal(ki[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(kv[b].numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ki.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(pv))
    assert torch.equal(ci, ki) and torch.equal(cv, kv)
    assert ki.dtype == torch.int32 and kv.dtype == torch.bool
    assert int(kv.sum()) > 0
    if span == 20:      # crowded: the survivors run out before K slots
        assert int(kv.sum()) < B * K


def test_batched_nms_matches_jax_per_image(no_launches):
    """Class-aware NMS with the offset taken per image, as FCOS.predict's
    vmap of batched_nms takes it."""
    rs = np.random.RandomState(7)
    B, N, K = 4, 300, 64
    boxes = _int_boxes(rs, B, N, 80, 10, 50)
    boxes[1] *= 3                       # images with different extents
    scores = rs.permutation(B * N).reshape(B, N).astype(np.float32) / (B * N)
    classes = rs.randint(0, 5, (B, N)).astype(np.int32)
    valid = rs.rand(B, N) > 0.2
    args = [torch.from_numpy(a) for a in (boxes, scores, classes)]
    ki, kv = t_nms.batched_nms(*args, 0.6, K, valid=torch.from_numpy(valid))
    ci, cv = t_nms.cuda_batched_nms(*args, 0.6, K, valid=torch.from_numpy(valid))
    want_i, want_v = jax.vmap(
        lambda bx, sc, cl, vl: j_nms.batched_nms(bx, sc, cl, 0.6, K, valid=vl)
    )(*(jnp.asarray(a) for a in (boxes, scores, classes, valid)))
    np.testing.assert_array_equal(ki.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(want_v))
    assert torch.equal(ci, ki) and torch.equal(cv, kv)


def test_nms_all_invalid_gives_no_detections():
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0]] * 4])
    ki, kv = t_nms.cuda_nms(boxes, torch.rand(1, 4), 0.5, 6,
                            valid=torch.zeros(1, 4, dtype=torch.bool))
    assert not kv.any() and not ki.any()


@pytest.mark.parametrize("L,C,k", [(300, 7, 50), (40, 5, 100), (10, 3, 500)])
def test_pair_top_k_matches_jax(L, C, k):
    rs = np.random.RandomState(L)
    B = 2
    rank = rs.permutation(B * L * C).reshape(B, L, C).astype(np.float32) / (B * L * C)
    tv, tl, tc = pair_top_k(torch.from_numpy(rank), k, approx=True)
    jv, jl, jc = j_topk.pair_top_k(jnp.asarray(rank), k, approx=False)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


def _stem_inputs(rs, B, H, W, cs):
    x = rs.randn(B, H, W, 3).astype(np.float32)
    w = (rs.randn(7, 7, 3, cs) * 0.1).astype(np.float32)
    scale = (rs.rand(cs) * 0.5 + 0.75).astype(np.float32)
    bias = (rs.randn(cs) * 0.1).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("B,H,W,cs", [(2, 16, 32, 64), (1, 48, 16, 32), (1, 36, 44, 16)])
def test_reference_stem_matches_jax(B, H, W, cs, no_launches):
    arrays = _stem_inputs(np.random.RandomState(H), B, H, W, cs)
    t = [torch.from_numpy(a) for a in arrays]
    got = t_fs.reference_stem(*t)
    want = np.asarray(j_fs.reference_stem(*(jnp.asarray(a) for a in arrays)))
    assert tuple(got.shape) == want.shape == (B, H // 4, W // 4, cs)
    assert _err(got.numpy(), want) <= KERNEL_TOL
    assert torch.equal(t_fs.fused_stem(*t), got)      # CPU: the plain version


def test_reference_stem_bf16_rounds_like_jax():
    """bf16 activations: the same rounding points (fold, fp32 sum, bias,
    relu, cast, pool), within the JAX test's bf16 tolerance."""
    x, w, scale, bias = _stem_inputs(np.random.RandomState(3), 1, 32, 32, 64)
    got = t_fs.reference_stem(torch.from_numpy(x).bfloat16(), *(
        torch.from_numpy(a) for a in (w, scale, bias)))
    want = j_fs.reference_stem(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == torch.bfloat16
    assert _err(got.float().numpy(), np.asarray(want, np.float32)) <= 3e-2


def test_stem_eligible():
    assert t_fs.stem_eligible((2, 800, 1344, 3), (7, 7, 3, 64))
    assert not t_fs.stem_eligible((2, 802, 1344, 3), (7, 7, 3, 64))
    assert not t_fs.stem_eligible((2, 800, 1344, 4), (7, 7, 4, 64))
    assert not t_fs.stem_eligible((2, 800, 1344, 3), (5, 5, 3, 64))


def _block_inputs(rs, B, H, W, cin, cm, cout, proj):
    def t(*shape, s=0.1):
        return (rs.randn(*shape) * s).astype(np.float32)
    arrays = [t(B, H, W, cin, s=1.0), t(cin, cm), t(cm), t(3, 3, cm, cm), t(cm),
              t(cm, cout), t(cout)]
    arrays += [t(cin, cout), t(cout)] if proj else [None, None]
    return arrays


@pytest.mark.parametrize("B,H,W,cin,cm,cout,proj", [
    (2, 13, 24, 64, 16, 64, True),     # ragged, projection
    (1, 16, 24, 64, 16, 64, False),    # identity shortcut
    (2, 7, 9, 32, 16, 32, False),      # odd sizes
])
def test_reference_bottleneck_matches_jax(B, H, W, cin, cm, cout, proj, no_launches):
    arrays = _block_inputs(np.random.RandomState(H + W), B, H, W, cin, cm, cout, proj)
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    got = t_fb.reference_bottleneck(*t)
    want = np.asarray(j_fb.reference_bottleneck(
        *(None if a is None else jnp.asarray(a) for a in arrays)))
    assert tuple(got.shape) == want.shape == (B, H, W, cout)
    assert _err(got.numpy(), want) <= KERNEL_TOL
    assert torch.equal(t_fb.fused_bottleneck(*t), got)   # CPU: the plain version


def test_fcos_locations_match_jax():
    for hw in ((64, 64), (800, 1344), (37, 50)):
        got, gc = t_anchors.fcos_locations(hw, (8, 16, 32, 64, 128))
        want, wc = j_anchors.fcos_locations(hw, (8, 16, 32, 64, 128))
        np.testing.assert_array_equal(got, want)
        assert gc == wc


def test_box_ops_match_jax():
    rs = np.random.RandomState(5)
    locs = (rs.rand(3, 50, 2) * 100).astype(np.float32)
    ltrb = (rs.rand(3, 50, 4) * 40).astype(np.float32)
    got = t_boxes.decode_ltrb(torch.from_numpy(locs), torch.from_numpy(ltrb))
    want = np.asarray(j_boxes.decode_ltrb(jnp.asarray(locs), jnp.asarray(ltrb)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_boxes.clip(got, 60.0, 80.0).numpy(),
        np.asarray(j_boxes.clip(jnp.asarray(want), 60.0, 80.0)))
    np.testing.assert_array_equal(
        t_boxes.area(got).numpy(), np.asarray(j_boxes.area(jnp.asarray(want))))
