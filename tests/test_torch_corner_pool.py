"""The port's corner pooling (``slenderobjdet_torch/ops/corner_pool.py``)
held against the JAX package's (``slenderobjdet_tpu/ops/corner_pool.py``)
on the CPU, where ``tl_pool`` and ``br_pool`` run the plain ``torch.cummax``
compositions (the CUDA kernel's oracle; the kernel itself is held against
them by the ``gpu`` cases of ``test_torch_package.py`` and by
``chip_smoke.py``):

- the four directions and both corners, forward, bit for bit;
- their gradients on tie-free inputs (continuous draws), within float32
  rounding of the order in which a credited element's terms are summed;
- the tie rule, stated: the gradient of a running max goes to the element
  found later in scan order (``torch.cummax``'s index, which the kernel
  follows), where autodiff through JAX's ``associative_scan`` splits a tie.
  CornerNet pools ReLU outputs, whose only ties in float32 are zeros, where
  ReLU's gradient is 0 in both packages; the model's gradients are compared
  in ``test_torch_cornernet.py``.

And the CPU models of the kernels' decompositions (``model_forward``:
channel chunks, bands of rows with look-back carries, row segments;
``model_backward``: a walk a line with deferred credit), at band, segment
and chunk sizes that divide none of H, W and C, on integers full of ties,
signed zeros and NaN: the forward bit for bit against the plain version
(and JAX's where there is no NaN; and with one input -0.0 everywhere, so
that the other's tie rule shows in the sign of every zero), the gradients exactly against the plain
version's autograd (integer gradients: every sum is exact).

Inputs come from numpy seeds inside each test. JAX takes NHWC, the port
NCHW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.ops import corner_pool as tcp
from slenderobjdet_tpu.ops import corner_pool as jcp

DIRECTIONS = ["top_pool", "bottom_pool", "left_pool", "right_pool"]
GRAD_TOL = 1e-6     # a credited element sums a few float32 terms in another order


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", DIRECTIONS)
def test_direction_forward_equals_jax(name):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 13, 5).astype(np.float32)
    x[0, 3:6, 4:8, 1] = 0.5                           # ties, forward only
    want = np.asarray(jax.jit(getattr(jcp, name))(jnp.asarray(x)))
    got = nhwc(getattr(tcp, name)(nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("corner", ["tl", "br"])
def test_corner_pool_forward_and_gradient_equal_jax(corner):
    """Forward bit for bit; the gradients of a weighted sum within float32
    rounding, with the same support (the credited elements)."""
    rs = np.random.RandomState(2)
    a, b = (rs.randn(2, 11, 7, 6).astype(np.float32) for _ in range(2))
    w = rs.randn(2, 11, 7, 6).astype(np.float32)
    jfn = getattr(jcp, f"{corner}_pool")

    def jloss(a_, b_):
        return jnp.sum(jfn(a_, b_) * w)

    want = np.asarray(jax.jit(jfn)(jnp.asarray(a), jnp.asarray(b)))
    want_ga, want_gb = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = nchw(a).requires_grad_(), nchw(b).requires_grad_()
    out = getattr(tcp, f"{corner}_pool")(ta, tb)
    np.testing.assert_array_equal(nhwc(out), want)
    (out * nchw(w)).sum().backward()
    for got, ref in ((nhwc(ta.grad), np.asarray(want_ga)), (nhwc(tb.grad), np.asarray(want_gb))):
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_allclose(got, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        assert (ref != 0).mean() < 0.6          # the max credits a subset


def test_tie_rule_is_torch_cummax_and_differs_from_jax_splitting():
    """``cummax([1, 1, 0, 1])`` credits indices [0, 1, 1, 3], so bottom_pool's
    gradient of the sum is [1, 2, 0, 1]; over four zeros every output
    credits itself. JAX splits tied credit ([0.25, 0.75, 1, 2] for
    top_pool of four zeros)."""
    x = torch.tensor([1.0, 1.0, 0.0, 1.0]).view(1, 1, 4, 1).requires_grad_()
    tcp.bottom_pool(x).sum().backward()
    assert x.grad.flatten().tolist() == [1.0, 2.0, 0.0, 1.0]
    z = torch.zeros(1, 1, 4, 1, requires_grad=True)
    tcp.top_pool(z).sum().backward()
    assert z.grad.flatten().tolist() == [1.0, 1.0, 1.0, 1.0]
    jz = jax.grad(lambda v: jnp.sum(jcp.top_pool(v)))(jnp.zeros((1, 4, 1, 1)))
    np.testing.assert_array_equal(np.asarray(jz).ravel(), [0.25, 0.75, 1.0, 2.0])


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    rs = np.random.RandomState(3)
    a, b = (torch.from_numpy(rs.randn(1, 4, 6, 5).astype(np.float32)) for _ in range(2))
    assert torch.equal(tcp.tl_pool(a, b), tcp.plain_tl_pool(a, b))
    assert torch.equal(tcp.br_pool(a, b), tcp.plain_br_pool(a, b))
    with pytest.raises(ValueError, match="CUDA"):
        tcp.launch_corner_pool(a, b, "tl")
    with pytest.raises(ValueError, match="CUDA"):
        tcp.launch_corner_pool_backward(a, b, a, "br")


MODEL_SHAPE = (2, 7, 13, 11)                 # B, C, H, W
MODEL_CUTS = [(3, 4, 3), (5, 16, 2), (13, 3, 16)]   # rows, segment, chunk


def _ties_signed_zeros_and_nan(rng, dtype, nan=True):
    """Integers 0-3 (ties everywhere), some -0.0 and, with ``nan``, NaN."""
    x = torch.from_numpy(rng.integers(0, 4, MODEL_SHAPE).astype(np.float32))
    x[torch.from_numpy(rng.random(MODEL_SHAPE) < 0.2) & (x == 0)] = -0.0
    if nan:
        x[torch.from_numpy(rng.random(MODEL_SHAPE) < 0.03)] = float("nan")
    return x.to(dtype)


def _signed_zeros(rng, dtype):
    """-1, -0.0 and +0.0: the maxima are zeros of either sign, so each tie
    decides a sign bit, which a sum with a constant -0.0 keeps."""
    values = np.array([-1.0, -0.0, 0.0], dtype=np.float32)
    return torch.from_numpy(rng.choice(values, MODEL_SHAPE)).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner", ["tl", "br"])
def test_kernel_model_forward_equals_plain_and_jax(corner, dtype):
    rng = np.random.default_rng(31)
    plain = getattr(tcp, f"plain_{corner}_pool")
    for nan in (True, False):
        a, b = (_ties_signed_zeros_and_nan(rng, dtype, nan) for _ in range(2))
        want = plain(a, b)
        assert bool(want.isnan().any()) == nan
        for rows, seg, chunk in MODEL_CUTS:
            got = tcp.model_forward(a, b, corner, rows, seg, chunk,
                                    gen=np.random.default_rng(rows))
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(_bits(got.nan_to_num()), _bits(want.nan_to_num()))
    zero = torch.full(MODEL_SHAPE, -0.0, dtype=dtype)
    for a, b in ((_signed_zeros(rng, dtype), zero), (zero, _signed_zeros(rng, dtype))):
        want = _bits(plain(a, b))                      # one direction's maxima, sign bits kept
        for rows, seg, chunk in MODEL_CUTS:
            got = tcp.model_forward(a, b, corner, rows, seg, chunk,
                                    gen=np.random.default_rng(rows))
            assert torch.equal(_bits(got), want)
    a, b = (_ties_signed_zeros_and_nan(rng, dtype, False).abs().float() for _ in range(2))
    jfn = getattr(jcp, f"{corner}_pool")
    want = np.asarray(jax.jit(jfn)(jnp.asarray(nhwc(a)), jnp.asarray(nhwc(b))))
    got = tcp.model_forward(a, b, corner, *MODEL_CUTS[0], gen=np.random.default_rng(0))
    np.testing.assert_array_equal(nhwc(got), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner", ["tl", "br"])
def test_kernel_model_gradients_equal_plain_autograd(corner, dtype):
    rng = np.random.default_rng(32)
    plain = getattr(tcp, f"plain_{corner}_pool")
    for nan in (True, False):
        a, b = (_ties_signed_zeros_and_nan(rng, dtype, nan) for _ in range(2))
        g = torch.from_numpy(rng.integers(-4, 5, MODEL_SHAPE).astype(np.float32))
        ta, tb = a.float().requires_grad_(), b.float().requires_grad_()
        (plain(ta, tb) * g).sum().backward()
        ga, gb = tcp.model_backward(a, b, g.to(dtype), corner)
        assert ga.dtype == dtype and gb.dtype == dtype
        assert torch.equal(ga.float(), ta.grad) and torch.equal(gb.float(), tb.grad)
        assert 0 < int((ta.grad != 0).sum()) < ta.numel()
