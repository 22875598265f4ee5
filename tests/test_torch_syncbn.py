"""SyncBN on the CPU: two gloo ranks (``parallel.launch``,
``tests/ddp_workers.py``) against one process on the joined batch, and that
process against the JAX package, in float32.

- One ``BatchNorm`` layer on the halves of a batch of 8: each rank's output
  and input-gradient rows and the running statistics equal the single
  process's within 1e-6, and the ranks' parameter gradients sum to its own:
  the statistics are the joined batch's, and the backward carries the other
  rank's terms.
- The tiny RepPointsGenerator with a ``SyncBN`` trunk (R-18, 192 x 256, its
  head's BatchNorms shared by five levels, FREEZE_AT 5), one ``TrainStep``
  through DDP on the halves of a joined batch of 4 whose halves hold
  unequal numbers of objects: parameters and running statistics bit-equal
  across the ranks, within 1e-5 of a tensor's largest value plus 5e-2 of
  its largest update of the single process's step (the criterion of
  ``tests/test_torch_ddp_train.py`` with 5e-2 for 1e-2: the head's float32
  gradients are ill-conditioned, see UPDATE_RTOL; a bias a BatchNorm follows, whose gradient is 0 up to
  rounding, within 1e-9), the running statistics within 1e-5 of its, the mean of the ranks'
  losses its loss.
- The single process's step against the JAX train step on the joined
  batch: loss, parameters (the same criterion) and running statistics.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import ddp_workers  # noqa: E402
from test_torch_ddp_train import joined_batch  # noqa: E402
from test_torch_proposal import STAT_RATIO, randomize, ratio, tiny_cfg  # noqa: E402

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.models.layers import BatchNorm, batch_statistics  # noqa: E402
from slenderobjdet_torch.parallel import launch  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.engine.train_loop import TrainState  # noqa: E402
from slenderobjdet_tpu.engine.train_loop import make_train_step as jax_train_step  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402

PARAM_RTOL = 1e-5     # tests/test_torch_ddp_train.py
# of a tensor's largest update: the RPG's OHEM cut and its BatchNorms at the
# coarse levels leave its head's float32 gradients ill-conditioned on
# random weights, the objectness tower's update differing by up to 3.4%
# between the joined batch and its halves (and 1.6% from JAX's)
UPDATE_RTOL = 5e-2
LOSS_RTOL = 1e-5
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
# the trunk frozen (its BatchNorms still normalise by the global batch and
# update their running statistics): on random weights at this size a
# BatchNorm trunk's float32 gradients are ill-conditioned, the port's
# float32 and float64 gradients of res5 differing by up to 9% and JAX's
# float32 by 27%; ``tests/test_torch_batchnorm.py`` holds the trunk's
# gradients at 1e-5 on the backbone alone
RPG_SYNCBN = {"MODEL.RESNETS.NORM": "SyncBN", "MODEL.BACKBONE.FREEZE_AT": 5,
              "SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.01}
SPEC_OVERRIDES = {"MODEL.META_ARCHITECTURE": "ProposalNetwork",
                  "MODEL.PROPOSAL_GENERATOR.NAME": "RepPointsGenerator",
                  "MODEL.RPN.IN_FEATURES": "['p3','p4','p5','p6','p7']",
                  "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", **RPG_SYNCBN}
# the larger half on rank 1; P7 2 x 2, so that no head norm sees two values
# a channel
BATCHES = [joined_batch(71, (1, 1, 5, 5), hw=(192, 256))]
# biases a BatchNorm follows: their gradient is 0 up to rounding
EXACT_ZERO = tuple(f"head.{t}_conv{i}.bias" for t in ("objectness", "deltas") for i in range(3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module (``test_torch_proposal.py``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layer_case():
    rs = np.random.RandomState(70)
    c = 16
    x = torch.from_numpy((rs.randn(8, c, 5, 7) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy(rs.randn(8, c, 5, 7).astype(np.float32))
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rs.randn(c).astype(np.float32)))
    return x, g, {k: v.clone() for k, v in bn.state_dict().items()}


@pytest.fixture(scope="module")
def syncbn_run(tmp_path_factory):
    """JAX's step, the single process's step, then one spawn of two gloo
    ranks running the layer and the model."""
    tmp = tmp_path_factory.mktemp("syncbn")
    jcfg = tiny_cfg(jax_get_cfg, **RPG_SYNCBN)
    det = jax_build_model(jcfg)
    variables = randomize(det.init_variables(jax.random.PRNGKey(3)), "RepPointsGenerator", 73)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = jsolver.build_optimizer(jcfg, jv["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                       buffers=jv["buffers"], opt_state=tx.init(jv["params"]))
    step = jax_train_step(det, tx, donate=False)
    jax_losses = []
    for b in BATCHES:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append(float(m["total_loss"]))
    jax_state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": state.params, "buffers": state.buffers})))

    spec = {"yaml": "configs/fcos/fcos_R_50_FPN_1x.yaml", "overrides": SPEC_OVERRIDES,
            "seed": 0, "steps": 1, "tol": (PARAM_RTOL, UPDATE_RTOL),
            "weights": str(tmp / "init.pt"), "exact_zero": EXACT_ZERO}
    model, _ = ddp_workers.build_family({**spec, "weights": None})
    load_flax_variables(model, variables)
    torch.save(model.state_dict(), spec["weights"])
    threads = torch.get_num_threads()
    torch.set_num_threads(ddp_workers.THREADS)
    try:
        model, tstep = ddp_workers.build_family(spec)
        init = {k: v.detach().clone() for k, v in model.named_parameters()}
        single = [{k: float(v) for k, v in tstep(dict(b)).items()} for b in BATCHES]
        x, g, layer_state = layer_case()
        bn = BatchNorm(x.shape[1])
        bn.load_state_dict(layer_state)
        xs = x.clone().requires_grad_(True)
        with batch_statistics():
            y = bn(xs)
        (y * g).sum().backward()
    finally:
        torch.set_num_threads(threads)
    torch.save(model.state_dict(), tmp / "single.pt")
    spec["refs"] = {1: str(tmp / "single.pt")}
    ranks = launch(ddp_workers.run_syncbn, 2, args=(x, g, layer_state, {"rpg": spec}, BATCHES),
                   backend="gloo", timeout=ddp_workers.GROUP_TIMEOUT,
                   join_timeout=ddp_workers.JOIN_TIMEOUT)
    return {"ranks": ranks, "single": (single, model, init), "jax": (jax_losses, jax_state),
            "layer": (y.detach(), xs.grad, bn), "tmp": tmp}


def test_layer_on_two_ranks_equals_the_joined_batch(syncbn_run):
    y, x_grad, bn = syncbn_run["layer"]
    r0, r1 = (r["layer"] for r in syncbn_run["ranks"])
    for key, want in (("y", y), ("x_grad", x_grad)):
        got = torch.cat([r0[key], r1[key]])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER_TOL, err_msg=key)
    for key, want in (("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad)):
        np.testing.assert_allclose((r0[key] + r1[key]).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for k in ("running_mean", "running_var"):
        assert torch.equal(r0["state"][k], r1["state"][k])
        np.testing.assert_allclose(r0["state"][k].numpy(), bn.state_dict()[k].numpy(),
                                   **LAYER_TOL)
    # each half alone has other statistics: the reduction made the difference
    with torch.no_grad(), batch_statistics(sync=False):
        alone = BatchNorm(y.shape[1])
        alone.load_state_dict(syncbn_run["ranks"][0]["layer"]["state"])
        half = alone(torch.zeros_like(y[:4]) + y[:4])
    assert not torch.allclose(half, r0["y"], atol=1e-3)


def test_rpg_syncbn_step_on_two_ranks_equals_the_joined_batch(syncbn_run):
    r0, r1 = (r["families"]["rpg"] for r in syncbn_run["ranks"])
    single, model, _ = syncbn_run["single"]
    assert r0["digest"] == r1["digest"]
    assert r0["excess"][1] <= 1 and r1["excess"][1] <= 1
    for i, want in enumerate(single):
        got = (r0["metrics"][i]["total_loss"] + r1["metrics"][i]["total_loss"]) / 2
        assert got == pytest.approx(want["total_loss"], rel=LOSS_RTOL), i
        assert r0["metrics"][i]["num_pos"] == r1["metrics"][i]["num_pos"] == want["num_pos"]
    own = dict(model.named_buffers())
    assert len(r0["running"]) == 2 * (20 + 6)
    for k, v in r0["running"].items():
        assert torch.equal(v, r1["running"][k]), k
        assert ratio(v.numpy(), own[k].numpy()) <= STAT_RATIO, k


def test_single_process_takes_the_jax_steps(syncbn_run):
    single, model, init = syncbn_run["single"]
    jax_losses, jax_state = syncbn_run["jax"]
    for got, want in zip(single, jax_losses):
        assert got["total_loss"] == pytest.approx(want, rel=1e-4)
    path = syncbn_run["tmp"] / "jax_params.pt"
    torch.save({k: v for k, v in jax_state.items() if "running" not in k}, path)
    assert ddp_workers.worst_excess(model, path, init, PARAM_RTOL, UPDATE_RTOL,
                                    EXACT_ZERO) <= 1
    for k, v in model.named_buffers():
        if "running" in k:
            assert ratio(v.numpy(), jax_state[k].numpy()) <= 1e-4, k
