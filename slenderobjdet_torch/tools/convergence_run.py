"""Train a registered meta-architecture for N steps on generated COCO-style
batches and report the loss trajectory and held-out precision and recall at
IoU 0.5 (counterpart of ``tools/convergence_run.py``: the same flags, batches,
config edits, log lines and final JSON line).

    python -m slenderobjdet_torch.tools.convergence_run \\
        --config-file configs/fcos/fcos_R_50_FPN_1x.yaml --steps 500 \\
        [--batch 8] [--hw 256 256] [--lr 0.01] [--num-classes 4] [--seed 0] \\
        [--log-every 50] [--weights model.pth] [--device cpu] [KEY VALUE ...]

Weights come from ``--weights`` where given, else they are drawn from
``--seed``. Without ``--device`` the model trains on the card: FCOS R-50-FPN
with ``MODEL.RESNETS.FUSED_STEM`` and ``FUSED_BLOCKS`` on launches 1 stem and
13 bottleneck kernels a step, and 1 stem, 13 bottleneck and 1 NMS kernel a
held-out predict call (4 calls).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ._common import add_model_args, build_and_load

HELD_OUT_BATCHES = 4
SCORE_THRESH = 0.3
IOU_THRESH = 0.5


def synth_batch(rng, batch_size, hw, num_classes, max_gt=8):
    """Visible solid rectangles on dark noise; the JAX script's draws in the
    same order."""
    h, w = hw
    imgs = rng.randint(0, 40, (batch_size, h, w, 3)).astype(np.uint8)
    boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    classes = np.zeros((batch_size, max_gt), np.int32)
    valid = np.zeros((batch_size, max_gt), bool)
    palette = np.stack([np.linspace(140, 255, num_classes)] * 3, 1)
    for i in range(batch_size):
        n = rng.randint(1, min(4, max_gt) + 1)
        for j in range(n):
            bw, bh = rng.randint(20, max(21, w // 3)), rng.randint(
                20, max(21, h // 3))
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            c = rng.randint(0, num_classes)
            imgs[i, y:y + bh, x:x + bw] = palette[c] + rng.randint(-10, 10, 3)
            boxes[i, j] = (x, y, x + bw, y + bh)
            classes[i, j] = c
            valid[i, j] = True
    return {"image": imgs, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 256])
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--num-classes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=50)
    add_model_args(ap, weights_help="a checkpoint of this package (.pth) to start from "
                                    "(default: weights drawn from --seed)")
    return ap.parse_args(argv)


def convergence_cfg(args):
    """The config file with the JAX script's edits: NUM_CLASSES on every head
    node, the LR steps at 0.7 and 0.9 of the run, at most 100 warm-up
    iterations, then the command line's KEY VALUE pairs."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    for key in ("FCOS", "RETINANET", "CORNER_NET", "REPPOINTS"):
        node = getattr(cfg.MODEL, key, None)
        if node is not None and hasattr(node, "NUM_CLASSES"):
            node.NUM_CLASSES = args.num_classes
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = args.num_classes
    if args.lr is not None:
        cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.MAX_ITER = args.steps
    cfg.SOLVER.STEPS = (int(args.steps * 0.7), int(args.steps * 0.9))
    cfg.SOLVER.WARMUP_ITERS = min(100, args.steps // 5)
    if args.opts:
        cfg.merge_from_list(list(args.opts))
    cfg.freeze()
    return cfg


def match_counts(gt, dets):
    """(tp, fp, fn) of one image: each detection, in score order, takes its
    highest-IoU gt if that IoU is at least IOU_THRESH and the gt is not yet
    taken; otherwise it is a false positive."""
    tp = fp = 0
    matched = np.zeros(len(gt), bool)
    for d in dets:
        x1 = np.maximum(d[0], gt[:, 0]); y1 = np.maximum(d[1], gt[:, 1])   # noqa: E702
        x2 = np.minimum(d[2], gt[:, 2]); y2 = np.minimum(d[3], gt[:, 3])   # noqa: E702
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        union = ((d[2] - d[0]) * (d[3] - d[1])
                 + (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) - inter)
        ious = inter / np.maximum(union, 1e-6)
        j = int(np.argmax(ious)) if len(gt) else -1
        if j >= 0 and ious[j] >= IOU_THRESH and not matched[j]:
            matched[j] = True
            tp += 1
        else:
            fp += 1
    return tp, fp, int((~matched).sum())


def held_out(model, args, hw):
    """Precision and recall over HELD_OUT_BATCHES batches drawn from
    ``--seed`` + 1, on the detections scoring above SCORE_THRESH."""
    dev = model.pixel_mean.device
    rng = np.random.RandomState(args.seed + 1)
    tp = fp = fn = 0
    for _ in range(HELD_OUT_BATCHES):
        batch = synth_batch(rng, args.batch, hw, args.num_classes)
        inputs = {"image": torch.as_tensor(batch["image"], device=dev),
                  "scale": torch.ones(args.batch, dtype=torch.float32, device=dev),
                  "orig_size": torch.tensor([list(hw)] * args.batch, dtype=torch.float32,
                                            device=dev)}
        with torch.no_grad():
            out = {k: v.cpu().numpy() for k, v in model.predict(inputs).items()}
        for i in range(args.batch):
            keep = out["valid"][i] & (out["scores"][i] > SCORE_THRESH)
            counts = match_counts(batch["gt_boxes"][i][batch["gt_valid"][i]],
                                  out["boxes"][i][keep])
            tp, fp, fn = tp + counts[0], fp + counts[1], fn + counts[2]
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def main(argv: Optional[List[str]] = None) -> dict:
    """Prints a log line at the first, every ``--log-every``-th and the last
    step and the final JSON line; returns that line's dict with the logged
    ``(iteration, loss)`` pairs under ``log``."""
    from ..engine import make_train_step
    from ..solver import build_optimizer

    args = parse_args(argv)
    cfg = convergence_cfg(args)
    model = build_and_load(cfg, args.weights, args.device, seed=args.seed)
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    dev = model.pixel_mean.device
    hw = tuple(args.hw)

    rng = np.random.RandomState(args.seed)
    logged = []
    t0 = time.time()
    for it in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in synth_batch(
            rng, args.batch, hw, args.num_classes).items()}
        metrics = step(batch)
        if it == 0 or (it + 1) % args.log_every == 0 or it == args.steps - 1:
            loss = float(metrics["total_loss"])
            logged.append((it + 1, loss))
            print(f"iter {it + 1}/{args.steps} loss={loss:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    precision, recall = held_out(model, args, hw)
    summary = {
        "config": args.config_file, "steps": args.steps,
        "first_loss": logged[0][1] if logged else None,
        "last_loss": logged[-1][1] if logged else None,
        "precision@0.5": round(precision, 3), "recall@0.5": round(recall, 3),
    }
    print(json.dumps(summary))
    return dict(summary, log=logged)


if __name__ == "__main__":
    main()
