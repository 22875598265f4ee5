"""``train_net_torch.py --device cpu --num-gpus 2`` on the CPU: two gloo ranks
started by ``parallel.launch`` with the backend ``launch_main`` gives the
CPU, ``main`` wrapped by ``ddp_workers.run_main`` to watch each rank (the
test at the end holds ``launch_main``'s own call to ``launch``), at
the tiny size of ``tests/test_torch_trainer.py`` (R-18, 64 x 80 images,
float32):

- 4 iterations with checkpoints at 2 and 4: rank 0 alone writes
  ``config.yaml``, ``metrics.json`` and the checkpoints, rank 1 nothing;
- ``--resume`` to 6 ends bit-equal (model, momentum, iteration) to an
  uninterrupted 2-rank run fed the same batches;
- the 2-rank checkpoint loads in a 1-process run, which trains one more
  iteration, and that 1-process checkpoint loads in a 2-rank
  ``--eval-only``: rank 0 gathers the detections of a 1-process
  ``--eval-only`` of it, and its ``bbox`` and ``ar`` equal that run's to
  1e-9; rank 1 returns ``{}``.

Each rank registers the synthetic dataset itself (a spawned process starts
with empty catalogs), runs torch on ``ddp_workers.THREADS`` threads, as the
1-process runs here do, and reports the files it opened for writing.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import ddp_workers  # noqa: E402
from synthetic import make_coco_json  # noqa: E402

import train_net_torch  # noqa: E402
from slenderobjdet_torch import parallel  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.parallel import launch  # noqa: E402

CONFIG = ddp_workers.ROOT / "configs/fcos/fcos_R_50_FPN_1x.yaml"
NAME = "torch_ddp_main_synth"
EVAL_TOL = 1e-9     # the metrics of the same detections, gathered or not
TINY = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.FCOS.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10, "MODEL.FCOS.INFERENCE_TH": 0.0,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.CHECKPOINT_PERIOD": 2,
}


def cli_args(out, *flags, **overrides):
    opts = {**TINY, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(CONFIG), "--device", "cpu", *flags]
        + [str(x) for kv in opts.items() for x in kv])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ddp_main")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    datasets = {NAME: (path, root)}
    ddp_workers.register_datasets(datasets)
    return tmp, datasets


def two_ranks(datasets, args, restart_after=None):
    """The two gloo ranks ``launch_main`` would start for ``args``, with
    ``main`` wrapped by ``ddp_workers.run_main``."""
    return launch(ddp_workers.run_main, args.num_gpus, args=(args, datasets, restart_after),
                  backend="gloo", timeout=ddp_workers.GROUP_TIMEOUT,
                  join_timeout=ddp_workers.JOIN_TIMEOUT)


def one_process(args):
    threads = torch.get_num_threads()
    torch.set_num_threads(ddp_workers.THREADS)
    try:
        return train_net_torch.main(args)
    finally:
        torch.set_num_threads(threads)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def assert_states_equal(got, want):
    assert got["iteration"] == want["iteration"]
    assert list(got["model"]) == list(want["model"])
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    for a, b in zip(got["optimizer"]["state"].values(), want["optimizer"]["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])


def detections(out):
    with open(out / "coco_instances_results.json") as f:
        return sorted(json.dumps(d, sort_keys=True) for d in json.load(f))


def assert_metrics_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_metrics_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_metrics_close(g, w, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_TOL, err_msg=path)


def test_two_ranks_train_resume_and_evaluate(synth):
    tmp, datasets = synth
    out = tmp / "two_ranks"
    # ---- 4 iterations, checkpoints at 2 and 4: rank 0 writes, rank 1 does not
    ranks = two_ranks(datasets, cli_args(out, "--num-gpus", "2", **{
        "SOLVER.MAX_ITER": 4, "DATASETS.TEST": ()}))
    assert ranks[0]["written"] == ["config.yaml", "last_checkpoint", "metrics.json",
                                   "model_0000002.pth.tmp", "model_0000004.pth.tmp"]
    assert ranks[1]["written"] == []
    assert sorted(p.name for p in out.glob("model_*")) == ["model_0000002.pth",
                                                           "model_0000004.pth"]
    state4 = load(out / "model_0000004.pth")
    assert not any(k.startswith(("module.", "model.")) for k in state4["model"])

    # ---- --resume to 6, against an uninterrupted 2-rank run on the same batches
    ranks = two_ranks(datasets, cli_args(out, "--num-gpus", "2", "--resume", **{
        "SOLVER.MAX_ITER": 6, "DATASETS.TEST": ()}))
    assert ranks[1]["written"] == [] and "model_0000006.pth.tmp" in ranks[0]["written"]
    straight = tmp / "straight"
    two_ranks(datasets, cli_args(straight, "--num-gpus", "2", **{
        "SOLVER.MAX_ITER": 6, "DATASETS.TEST": ()}), restart_after=4)
    resumed = load(out / "model_0000006.pth")
    assert_states_equal(resumed, load(straight / "model_0000006.pth"))
    assert not torch.equal(resumed["model"]["head.cls_logits.weight"],
                           state4["model"]["head.cls_logits.weight"])

    # ---- the 2-rank checkpoint in one process, and that process's in two ranks
    single = tmp / "single"
    shutil.copytree(out, single)
    one_process(cli_args(single, "--resume", **{"SOLVER.MAX_ITER": 7, "DATASETS.TEST": ()}))
    assert (single / "last_checkpoint").read_text() == "model_0000007"
    want = one_process(cli_args(single, "--resume", "--eval-only", **{"SOLVER.MAX_ITER": 7}))
    want_dets = detections(single)
    ranks = two_ranks(datasets, cli_args(single, "--num-gpus", "2", "--resume", "--eval-only",
                                         **{"SOLVER.MAX_ITER": 7}))
    assert ranks[1]["result"] == {} and ranks[1]["written"] == []
    assert {"coco_instances_results.json", "evaluate_metrics.json"} <= set(ranks[0]["written"])
    # the gathered detections are the 1-process run's, and so are the metrics
    assert detections(single) == want_dets and len(want_dets) > 100
    got = ranks[0]["result"][NAME]
    assert set(STATS_NAMES) <= set(got["bbox"]) and np.isfinite(got["bbox"]["AP"])
    assert_metrics_close(got["bbox"], want[NAME]["bbox"])
    assert_metrics_close(got["ar"], want[NAME]["ar"])


def test_the_command_line_launches_its_ranks(monkeypatch):
    """``launch_main`` hands ``main`` and the flags to ``launch``; the CPU
    takes gloo, and no flag names a backend."""
    calls = []
    monkeypatch.setattr(parallel, "launch", lambda *a, **k: calls.append((a, k)) or ["r"])
    args = train_net_torch.default_argument_parser().parse_args(
        ["--device", "cpu", "--num-gpus", "2", "--num-machines", "3", "--machine-rank", "1",
         "--dist-url", "tcp://10.0.0.1:2345", "SOLVER.MAX_ITER", "1"])
    assert train_net_torch.launch_main(args) == ["r"]
    (func, num_gpus), kwargs = calls[0]
    assert func is train_net_torch.main and num_gpus == 2
    assert kwargs == {"num_machines": 3, "machine_rank": 1, "dist_url": "tcp://10.0.0.1:2345",
                      "args": (args,), "backend": "gloo"}
    assert train_net_torch.default_argument_parser().parse_args([]).num_gpus == 1
