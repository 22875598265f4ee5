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


def test_stem_weight_packing_round_trips():
    """The tensor-core stem's weights: folded, rounded to bf16, and every one
    where the kernel's B fragment reads it; unpacking gives back the folded
    weights in the JAX HWIO layout exactly."""
    _, w, scale, _ = _stem_inputs(np.random.RandomState(11), 1, 8, 8, 64)
    w, scale = torch.from_numpy(w), torch.from_numpy(scale)
    folded = (w * scale).bfloat16()
    np.testing.assert_array_equal(
        folded.float().numpy(),
        np.asarray((jnp.asarray(w.numpy()) * jnp.asarray(scale.numpy()))
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    packed = t_fs.pack_stem_weights(w, scale)
    assert packed.shape == (11, 4, 32, 4, 2) and packed.is_contiguous()
    assert packed.dtype == torch.bfloat16 and packed.numel() * 2 == 22528
    assert torch.equal(t_fs.unpack_stem_weights(packed), folded)
    wk = t_fs.stem_weight_matrix(folded)
    assert wk.shape == (176, 64)
    # lane 4 g + t, register 2 n2 + h of pair q, element e of step s
    for s, q, g, t, n2, h, e in ((0, 0, 0, 0, 0, 0, 0), (3, 2, 5, 1, 1, 0, 1),
                                 (10, 3, 7, 3, 1, 1, 1), (7, 1, 2, 2, 0, 1, 0)):
        assert packed[s, q, 4 * g + t, 2 * n2 + h, e] == \
            wk[16 * s + 8 * h + 2 * t + e, 8 * (2 * q + n2) + g]
    # tap (ky, kx, ci) sits in slot 1 + 3 kx + ci of its ky group; the lead
    # slot, slots 22-23 and the K padding hold zeros
    assert torch.equal(wk[24 * 4 + 1 + 3 * 5 + 2], folded[4, 5, 2])
    groups = wk[:168].reshape(7, 24, 64)
    assert not groups[:, 0].any() and not groups[:, 22:].any() and not wk[168:].any()


@pytest.mark.parametrize("cs", [64, 16])
def test_stem_padded_k_gemm_over_raw_window_is_the_conv(cs):
    """The tensor-core kernel's arithmetic without a card: A read straight
    from the raw NHWC rows (one lead element, then 3 values a pixel, a conv
    column's patch row starting 6 elements after its neighbour's, 24 slots a
    ky of which 3 meet zero weights) times ``stem_weight_matrix``, bf16
    operands and fp32 sums, equals ``reference_stem``'s conv before the pool
    (1e-5 of the max: two fp32 summation orders of the same products)."""
    B, H, W = 2, 36, 52
    x, w, scale, bias = _stem_inputs(np.random.RandomState(cs), B, H, W, cs)
    x = torch.from_numpy(x).bfloat16().float()
    folded = (torch.from_numpy(w) * torch.from_numpy(scale)).bfloat16()
    rows = torch.nn.functional.pad(x, (0, 0, 3, 4, 3, 3))   # + 1 px for slots 22-23
    rows = torch.nn.functional.pad(rows.reshape(B, H + 6, -1), (1, 0))
    hc, wc = H // 2, W // 2
    ky, slot = np.divmod(np.arange(168), 24)
    i, j = np.divmod(np.arange(hc * wc), wc)
    a = rows[:, (2 * i[:, None] + ky[None, :]), (6 * j[:, None] + slot[None, :])]
    a = torch.nn.functional.pad(a, (0, 8), value=1.0)     # K padding: any finite value
    got = (a @ t_fs.stem_weight_matrix(folded).float()).reshape(B, hc, wc, cs)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), folded.float().permute(3, 2, 0, 1), stride=2,
        padding=3).permute(0, 2, 3, 1)
    assert _err(got.numpy(), want.numpy()) <= 1e-5
    # and through bias, relu, rounding and the pool it is reference_stem
    y = torch.relu(got + torch.from_numpy(bias)).bfloat16().float()
    pooled = torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1)
    ref = t_fs.reference_stem(x.bfloat16(), torch.from_numpy(w),
                              torch.from_numpy(scale), torch.from_numpy(bias))
    assert _err(pooled.permute(0, 2, 3, 1).numpy(), ref.float().numpy()) <= 3e-2


@pytest.mark.parametrize("dtype,batch,h,w,cs,route", [
    (torch.bfloat16, 8, 800, 1344, 64, "mma"),
    (torch.bfloat16, 2, 36, 52, 64, "mma"),        # ragged in both directions
    (torch.bfloat16, 3, 4, 4, 64, "mma"),          # fewer tiles than SMs
    (torch.bfloat16, 2, 36, 52, 16, "cuda_cores"),
    (torch.float32, 2, 36, 52, 64, "cuda_cores"),
])
def test_stem_plan_covers_every_pooled_pixel_once(dtype, batch, h, w, cs, route):
    plan = t_fs.stem_plan(dtype, batch, h, w, cs)
    assert plan["route"] == route
    seen = np.zeros((batch, h // 4, w // 4), np.int32)
    ctas = set()
    for cta, b, rows, cols in t_fs.stem_tiles(plan, batch, h, w):
        assert 0 <= cta < plan["grid"]
        assert rows.stop - rows.start <= plan["tile"][0]
        assert cols.stop - cols.start <= plan["tile"][1]
        seen[b, rows, cols] += 1
        ctas.add(cta)
    assert (seen == 1).all() and len(ctas) == plan["grid"]
    if route == "mma":          # a persistent grid, one CTA an SM at most
        assert plan["grid"] == min(plan["tiles"], t_fb.H100_SMS)


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


# R-50's stride-1 block shapes at 800x1344: H, W, Cin, Cm, Cout
R50_BLOCKS = [(200, 336, 64, 64, 256), (200, 336, 256, 64, 256),
              (100, 168, 512, 128, 512), (50, 84, 1024, 256, 1024),
              (25, 42, 2048, 512, 2048)]


@pytest.mark.parametrize("cin,cm,cout,proj,bn", [
    (64, 128, 128, False, 128),
    (256, 128, 512, True, 256),
    (1024, 256, 1024, False, 256),
    (512, 512, 1024, True, 128),
])
def test_wgmma_weight_packing_round_trips(cin, cm, cout, proj, bn):
    """The wgmma path's re-layout: every weight lands where the kernel's
    descriptor reads it, and unpacking gives back the JAX-layout tensors
    (HWIO w2, (Cin, Cm) w1, (Cm, Cout) w3 and (Cin, Cout) wsc) exactly."""
    rs = np.random.RandomState(cin + cm)
    w1, w2, w3 = (torch.from_numpy(rs.randn(*s).astype(np.float32)).bfloat16()
                  for s in ((cin, cm), (3, 3, cm, cm), (cm, cout)))
    wsc = torch.from_numpy(rs.randn(cin, cout).astype(np.float32)).bfloat16() if proj else None
    k1, k2, k3 = t_fb.conv_weight_matrices(w1, w2, w3, wsc)
    for wk, n in ((k1, cm), (k2, cm), (k3, cout)):
        b = bn if n % bn == 0 else 128
        packed = t_fb.pack_conv_weights(wk, b)
        assert packed.is_contiguous() and packed.numel() == wk.numel()
        # [N / bn][K / 64][k16 slice j][n group][k half][8 n][8 k]
        last_nt, last_ks = n // b - 1, wk.shape[0] // 64 - 1
        for nt, ks, j, ng, kh, ni, ki in ((0, 0, 0, 0, 0, 0, 0),
                                          (min(1, last_nt), min(1, last_ks), 3, 5, 1, 7, 6),
                                          (last_nt, last_ks, 2, b // 8 - 1, 0, 3, 2)):
            assert torch.equal(packed[nt, ks, j, ng, kh, ni, ki],
                               wk[ks * 64 + j * 16 + kh * 8 + ki, nt * b + ng * 8 + ni])
        assert torch.equal(t_fb.unpack_conv_weights(packed, b), wk)
    un2 = t_fb.unpack_conv_weights(t_fb.pack_conv_weights(k2, 128), 128)
    assert torch.equal(un2.reshape(3, 3, cm, cm), w2)
    un3 = t_fb.unpack_conv_weights(t_fb.pack_conv_weights(k3, 128), 128)
    assert torch.equal(un3[:cm], w3)
    if proj:
        assert torch.equal(un3[cm:], wsc)
    assert torch.equal(t_fb.conv_weight_matrices(w1, w2, w3, mode="notap")[1], w2[1, 1])


def _covered_once(plan, batch, h, w, cm, cout):
    """Each conv's (or the on-chip block's) tiles cover every (pixel, output
    channel) of its output exactly once."""
    m = batch * h * w
    counts = {}
    for conv, ps, cs in t_fb.plan_tiles(plan, batch, h, w, cm, cout):
        n = cm if conv in ("conv1", "conv2") else cout
        assert 0 <= ps.start < ps.stop <= m and 0 <= cs.start < cs.stop <= n
        c = counts.setdefault(conv, np.zeros((m, n // 8), np.int32))
        c[ps, cs.start // 8:cs.stop // 8] += 1
    want = {"conv1", "conv2", "conv3"} if plan["route"] == "wgmma" else {"block"}
    assert set(counts) == want
    for c in counts.values():
        assert (c == 1).all()


@pytest.mark.parametrize("h,w,cin,cm,cout", R50_BLOCKS)
def test_bottleneck_tile_plan_covers_r50_shapes(h, w, cin, cm, cout):
    """At R-50's five stride-1 shapes, bf16, B = 2: every one takes the
    wgmma path, its tiles cover every output exactly once (25x42 included)
    and waste only the last tile's rows; fp32 stays on chip and covers
    every output once too."""
    plan = t_fb.bottleneck_plan(torch.bfloat16, 2, h, w, cin, cm, cout)
    assert plan["route"] == "wgmma"
    assert plan["m_tiles"] * t_fb.GEMM_M - 2 * h * w < t_fb.GEMM_M
    _covered_once(plan, 2, h, w, cm, cout)
    plan = t_fb.bottleneck_plan(torch.float32, 1, h, w, cin, cm, cout)
    assert plan["route"] == "cuda_cores"
    _covered_once(plan, 1, h, w, cm, cout)


@pytest.mark.parametrize("dtype,batch,h,w,cin,cm,cout", [
    (torch.bfloat16, 1, 1, 1, 64, 128, 128),
    (torch.bfloat16, 3, 7, 9, 128, 128, 256),
    (torch.bfloat16, 2, 13, 5, 512, 512, 2048),
    (torch.bfloat16, 2, 13, 21, 64, 64, 256),      # wgmma, BN = 64
    (torch.bfloat16, 2, 13, 21, 64, 32, 64),       # on chip, CUDA cores
    (torch.float32, 2, 13, 21, 64, 128, 128),      # on chip, CUDA cores
    (torch.bfloat16, 1, 3, 5, 48, 16, 48),         # on chip, CUDA cores
])
def test_bottleneck_tile_plan_covers_ragged_shapes(dtype, batch, h, w, cin, cm, cout):
    plan = t_fb.bottleneck_plan(dtype, batch, h, w, cin, cm, cout)
    _covered_once(plan, batch, h, w, cm, cout)


def test_bottleneck_plan_routes_and_tiles():
    """The kernel and tile choices: wgmma only for aligned bf16 blocks with
    Cin, Cm and Cout % 64 == 0; BN = 256 where that still fills every SM
    (res5 at B = 8), else 128, else 64 (Cm = 64 at res2); the on-chip tile is
    the largest that fits in shared memory."""
    plan = t_fb.bottleneck_plan(torch.bfloat16, 8, 25, 42, 2048, 512, 2048)
    assert plan == {"route": "wgmma", "m_tiles": 66,
                    "bn": {"conv1": 256, "conv2": 256, "conv3": 256}}
    plan = t_fb.bottleneck_plan(torch.bfloat16, 1, 25, 42, 2048, 512, 2048)
    assert plan["bn"] == {"conv1": 128, "conv2": 128, "conv3": 128}
    assert t_fb.bottleneck_plan(torch.bfloat16, 8, 100, 168, 512, 128, 512)["bn"] == {
        "conv1": 128, "conv2": 128, "conv3": 256}
    assert t_fb.bottleneck_plan(torch.bfloat16, 8, 25, 42, 2048, 512, 2048,
                                aligned=False)["route"] == "cuda_cores"
    assert t_fb.bottleneck_plan(torch.float32, 8, 25, 42, 2048, 512, 2048) == {
        "route": "cuda_cores", "tile": (4, 8)}
    assert t_fb.bottleneck_plan(torch.bfloat16, 8, 200, 336, 256, 64, 256) == {
        "route": "wgmma", "m_tiles": 4200,
        "bn": {"conv1": 64, "conv2": 64, "conv3": 256}}
    assert t_fb.bottleneck_plan(torch.bfloat16, 8, 200, 336, 64, 32, 64) == {
        "route": "cuda_cores", "tile": (8, 16)}
    assert t_fb.onchip_tile(512, 2) == (8, 8)
    assert t_fb.onchip_smem_bytes(8, 8, 512, 2) <= t_fb.SMEM_LIMIT
    assert t_fb.onchip_smem_bytes(8, 16, 512, 2) > t_fb.SMEM_LIMIT


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
