"""What the data-parallel tests run in each rank (``tests/test_torch_ddp*.py``,
``tests/test_torch_syncbn.py``).

The ranks are spawned processes, which unpickle these functions by module
name: this module imports torch and the port only (no jax), so that a rank
starts in seconds. Every rank runs torch on ``THREADS`` intra-op threads,
as does the single-process reference it is held against: the reduction
order of a convolution can flip a ReLU of a random backbone.
"""

import datetime
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
THREADS = 1
GROUP_TIMEOUT = datetime.timedelta(seconds=120)   # each collective
JOIN_TIMEOUT = 240.0                              # each spawn, whole

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def family_cfg(yaml, overrides):
    from slenderobjdet_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / yaml))
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def build_family(spec):
    """The model, its optimizer and its train step of one family spec:
    ``{"yaml", "overrides", "seed", "weights"}`` (``weights``: a state-dict
    file, or None for the seeded draw)."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    cfg = family_cfg(spec["yaml"], spec["overrides"])
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(spec["seed"]))
    if spec.get("weights"):
        model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    return model, step


def rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def worst_excess(model, path, init, rtol, update_rtol, exact_zero=()) -> float:
    """Over the trainable tensors, the largest max |got - want| over what
    is allowed: ``rtol`` of the tensor's largest value plus ``update_rtol``
    of its largest update since ``init``. At most 1 passes. (A head bias
    after GroupNorm sits near 1e-6 with a gradient that cancels to rounding,
    so its own scale alone would measure the summation order.) A tensor in
    ``exact_zero`` (a bias a BatchNorm follows, whose gradient is 0 up to
    rounding) is allowed 1e-9 absolute."""
    want = torch.load(path, weights_only=True)
    worst = 0.0
    for name, p in model.named_parameters():
        w = want[name].double()
        if name in exact_zero:
            worst = max(worst, float((p.detach().double() - w).abs().max()) / 1e-9)
            continue
        allowed = (rtol * float(w.abs().max())
                   + update_rtol * float((w - init[name].double()).abs().max()))
        diff = float((p.detach().double() - w).abs().max())
        if diff > 0:
            worst = max(worst, diff / allowed if allowed > 0 else float("inf"))
    return worst


def run_families(specs, batches):
    """Each family's steps on this rank's rows of the joined ``batches``:
    per step the rank's metrics, after the steps listed in a spec's
    ``refs`` (``{step: state-dict file}``) the worst excess of the
    parameters over ``spec["tol"]`` (``worst_excess``) against that file,
    and at the end the digest of the model's state, its ``loss_normalizer``
    where it has one and its BatchNorms' running statistics."""
    from slenderobjdet_torch.engine.train_loop import step_generator
    from slenderobjdet_torch.parallel import process_count, process_index, state_digest

    torch.set_num_threads(THREADS)
    rank, world = process_index(), process_count()
    out = {}
    for name, spec in specs.items():
        model, step = build_family(spec)
        init = {k: v.detach().clone() for k, v in model.named_parameters()}
        got = {"metrics": [], "excess": {}}
        for i, joined in enumerate(batches[:spec["steps"]]):
            local = len(joined["image"]) // world
            batch = rows(joined, rank * local, (rank + 1) * local)
            batch["generator"] = step_generator(spec["seed"], i, "cpu", rank)
            got["metrics"].append({k: float(v) for k, v in step(batch).items()})
            if i + 1 in spec.get("refs", {}):
                got["excess"][i + 1] = worst_excess(model, spec["refs"][i + 1], init,
                                                    *spec["tol"], spec.get("exact_zero", ()))
        got["digest"] = state_digest(model)
        if hasattr(model, "loss_normalizer"):
            got["loss_normalizer"] = float(model.loss_normalizer)
        got["running"] = {k: v.clone() for k, v in model.named_buffers() if "running_" in k}
        out[name] = got
    return out


def run_batchnorm_layer(x, g, state):
    """One trainable BatchNorm (``state``: its state dict) on this rank's
    rows of the joined NCHW ``x``, with batch statistics reduced over the
    group: this rank's output rows and input gradient rows (the upstream
    gradient ``g``), its parameter gradients and the running statistics."""
    from slenderobjdet_torch.models.layers import BatchNorm, batch_statistics
    from slenderobjdet_torch.parallel import process_count, process_index

    rank, world = process_index(), process_count()
    local = x.shape[0] // world
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(state)
    xs = x[rank * local:(rank + 1) * local].clone().requires_grad_(True)
    with batch_statistics():
        y = bn(xs)
    (y * g[rank * local:(rank + 1) * local]).sum().backward()
    return {"y": y.detach(), "x_grad": xs.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "state": bn.state_dict()}


def rank_and_world():
    from slenderobjdet_torch.parallel import process_count, process_index

    return process_index(), process_count()


def register_datasets(datasets):
    from slenderobjdet_torch.data import catalog
    from slenderobjdet_torch.data.datasets import coco

    for name, (json_file, root) in datasets.items():
        catalog.DatasetCatalog.remove(name)
        coco.register_coco_instances(name, json_file, root)


def run_main(args, datasets, restart_after=None):
    """``train_net_torch.main(args)`` on this rank with ``datasets`` (name:
    (json, image root)) registered. Returns its result and the files the
    rank opened for writing under ``OUTPUT_DIR`` (``open`` and
    ``torch.save``). ``restart_after`` k
    feeds the train loop the stream's first k batches and then the stream
    again, as a resumed run sees it."""
    import train_net_torch
    from slenderobjdet_torch.engine import trainer as ttrainer

    torch.set_num_threads(THREADS)
    register_datasets(datasets)
    out_dir = os.path.realpath(train_net_torch.setup(args).OUTPUT_DIR)
    written = set()
    active = [True]     # an audit hook cannot be removed: it goes quiet

    def record(path):
        path = os.path.realpath(path)
        if active[0] and path.startswith(out_dir + os.sep):
            written.add(os.path.relpath(path, out_dir))

    def audit(event, event_args):
        if event == "open" and isinstance(event_args[0], str):
            mode, flags = event_args[1], event_args[2]
            if (any(c in mode for c in "wax+") if isinstance(mode, str)
                    else flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
                record(event_args[0])

    real_save = torch.save

    def recorded_save(obj, f, *a, **k):    # its file is opened in C++
        if isinstance(f, (str, os.PathLike)):
            record(f)
        return real_save(obj, f, *a, **k)

    sys.addaudithook(audit)
    torch.save = recorded_save
    if restart_after is not None:
        real_loader = ttrainer.build_detection_train_loader

        def restarting_loader(cfg, seed=0):
            def stream():
                head = iter(real_loader(cfg, seed=seed))
                for _ in range(restart_after):
                    yield next(head)
                yield from real_loader(cfg, seed=seed)
            return stream()

        ttrainer.build_detection_train_loader = restarting_loader
    try:
        result = train_net_torch.main(args)
    finally:
        active[0] = False
        torch.save = real_save
    return {"result": result, "written": sorted(written)}


def run_syncbn(x, g, state, specs, batches):
    """``run_batchnorm_layer`` then ``run_families``, in one spawn."""
    torch.set_num_threads(THREADS)
    return {"layer": run_batchnorm_layer(x, g, state), "families": run_families(specs, batches)}
