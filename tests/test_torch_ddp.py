"""The PyTorch port's data-parallel plumbing on the CPU, in one process:

- the ``parallel`` helpers pass through with no process group, as
  ``tests/test_multihost.py::test_multihost_helpers_single_process`` holds
  the JAX ones, and ``launch`` of one process runs in the caller;
- the train loader's shards are the JAX loader's shards, bit for bit, for
  an explicit ``shard_id`` / ``num_shards`` (workers 0 and 2, 3 global
  batches), and the strided test subsets are JAX's for 3 shards;
- ``step_generator``: rank 0 draws what a single process drew before ranks
  existed, and rank 1 draws otherwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.data import build as tbuild  # noqa: E402
from slenderobjdet_torch.engine.train_loop import step_generator  # noqa: E402
from slenderobjdet_torch.parallel import launch, multihost  # noqa: E402
from slenderobjdet_tpu.data import build as jbuild  # noqa: E402
from test_torch_data import NAME, assert_batches_equal, cfg_pair, dataset  # noqa: E402,F401


# ------------------------------------------------------------------ helpers
def test_helpers_pass_through_without_a_group():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_main_process()
    obj = {"a": [1, 2]}
    assert multihost.all_gather_objects(obj) == [obj]
    multihost.sync_processes()
    x = torch.tensor(3.0, requires_grad=True)
    assert multihost.global_sum(x * 2).item() == 6.0
    count = torch.tensor(0.0)
    n, share = multihost.global_normalizer(count, 1.0)
    assert n.item() == share.item() == 1.0
    third = torch.tensor(1 / 3)
    assert torch.equal(multihost.process_share(third), third)
    # the digest reads every dtype's bytes, bf16 included
    a, b = torch.nn.Linear(2, 3).bfloat16(), torch.nn.Linear(2, 3).bfloat16()
    b.load_state_dict(a.state_dict())
    assert multihost.state_digest(a) == multihost.state_digest(b)
    with torch.no_grad():
        b.bias[1] += 1
    assert multihost.state_digest(a) != multihost.state_digest(b)
    assert multihost.mean_over_processes({"a": torch.tensor(2.5), "n": torch.tensor(4)}) == \
        {"a": 2.5, "n": 4.0}
    # the quotient whose normaliser carries a gradient: the plain one, bit for bit
    grads = []
    for quotient in (multihost.global_quotient,
                     lambda a, b, floor: a / torch.clamp(b, min=floor)):
        num, den = torch.tensor(5.0, requires_grad=True), torch.tensor(0.3, requires_grad=True)
        q = quotient(num, den, 1e-6)
        q.backward()
        grads.append((q.item(), num.grad.item(), den.grad.item()))
    assert grads[0] == grads[1]


def test_launch_of_one_process_runs_in_the_caller():
    assert launch(os.getpid, 1) == [os.getpid()]
    assert launch(multihost.process_count, 1, args=()) == [1]


# ------------------------------------------------------------------ loaders
@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_shards_are_the_jax_loaders_shards(dataset, workers):
    jcfg, tcfg = cfg_pair(**{"DATALOADER.NUM_WORKERS": workers, "SOLVER.IMS_PER_BATCH": 4})
    for shard in range(2):
        want = iter(jbuild.build_detection_train_loader(jcfg, seed=3, shard_id=shard,
                                                        num_shards=2))
        got = iter(tbuild.build_detection_train_loader(tcfg, seed=3, shard_id=shard,
                                                       num_shards=2))
        for _ in range(3):
            g, w = next(got), next(want)
            assert_batches_equal(g, w)
            assert g["image"].shape[0] == 2


def test_test_subsets_are_the_jax_strided_subsets(dataset):
    jcfg, tcfg = cfg_pair(**{"DATALOADER.NUM_WORKERS": 0, "INPUT.MAX_SIZE_TEST": 160})
    ids = []
    for shard in range(3):
        want = list(jbuild.build_detection_test_loader(jcfg, NAME, batch_size=2,
                                                       shard_id=shard, num_shards=3))
        got = list(tbuild.build_detection_test_loader(tcfg, NAME, batch_size=2,
                                                      shard_id=shard, num_shards=3))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
        ids.append(sorted(i for b in got for i, v in zip(b["image_id"], b["batch_valid"]) if v))
    assert ids == [list(range(1 + s, 13, 3)) for s in range(3)]


# -------------------------------------------------------------- the draws
def test_step_generator_folds_the_rank_in_and_rank_0_draws_as_before():
    for seed, it in ((0, 0), (5, 17), (-1, 3)):
        before = torch.Generator().manual_seed(((max(seed, 0) + 7919) << 32) + it)
        want = torch.rand(8, generator=before)
        assert torch.equal(torch.rand(8, generator=step_generator(seed, it, "cpu")), want)
        assert torch.equal(torch.rand(8, generator=step_generator(seed, it, "cpu", 0)), want)
        other = torch.rand(8, generator=step_generator(seed, it, "cpu", 1))
        assert not torch.equal(other, want)
        assert torch.equal(torch.rand(8, generator=step_generator(seed, it, "cpu", 1)), other)
    draws = {tuple(torch.rand(4, generator=step_generator(0, 2, "cpu", r)).tolist())
             for r in range(8)}
    assert len(draws) == 8
    np.testing.assert_array_equal(  # a rank's draws do not repeat another iteration's
        torch.rand(4, generator=step_generator(0, 1, "cpu", 1)).numpy() ==
        torch.rand(4, generator=step_generator(0, 2, "cpu", 0)).numpy(), False)


def test_launch_under_torchrun_joins_the_group_it_names(monkeypatch):
    """With torchrun's variables set the caller is one rank already: it
    joins the group (gloo on the CPU) and runs the function itself."""
    import torch.distributed as dist

    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}.items():
        monkeypatch.setenv(key, value)

    def inside():
        return multihost.process_count(), dist.get_backend(), os.getpid()

    assert launch(inside, 8, backend="gloo") == [(1, "gloo", os.getpid())]
    assert not dist.is_initialized()


def test_launch_of_two_machines_numbers_the_ranks_machine_major(tmp_path):
    """Two "machines" of one process each on this host, meeting at a file
    rendezvous (no port to collide): machine 1's process is rank 1 of 2."""
    from concurrent.futures import ThreadPoolExecutor

    from ddp_workers import GROUP_TIMEOUT, JOIN_TIMEOUT, rank_and_world

    url = f"file://{tmp_path / 'rendezvous'}"
    with ThreadPoolExecutor(2) as pool:
        machines = [pool.submit(launch, rank_and_world, 1, num_machines=2, machine_rank=m,
                                dist_url=url, backend="gloo", timeout=GROUP_TIMEOUT,
                                join_timeout=JOIN_TIMEOUT) for m in (0, 1)]
        assert [m.result() for m in machines] == [[(0, 2)], [(1, 2)]]
    with pytest.raises(AssertionError, match="one machine"):
        launch(os.getpid, 1, num_machines=2)
