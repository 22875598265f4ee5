"""Hold the port's FCOS R-50-FPN at the loader's full size to the JAX
package's outputs committed in ``tests/data/fcos_r50_full_size.npz``.

    python -m slenderobjdet_torch.tools.full_size_check [--device cpu]
        [--dtype float32|bfloat16] [--buckets landscape portrait]

``tools/make_torch_full_size_reference.py`` wrote the file: the manifest of
the model's leaves with their draw rules, the seeds, a checksum of the drawn
weights, and per padded bucket (896 x 1408 and 1408 x 896, B = 1, fp32,
exact top-k) the 100 detections and a seeded sample of the head per FPN
level. This module rebuilds the weights from the manifest in numpy
(``checkpoint/bridge.py:seeded_flax_variables``), draws the same images,
runs ``predict`` and compares:

- the head sample: per level and output, max |port - JAX| <= ``HEAD_RTOL``
  x max |JAX|;
- the detections (``match_detections``): every valid JAX detection has a
  port detection of the same class with its box within ``BOX_ATOL`` px and
  its score within ``SCORE_ATOL``, and the port has as many valid ones.
  Slots are paired in score order, except that detections whose scores lie
  within ``SCORE_ATOL`` of a neighbour's form a tie group and are paired as
  a set; a JAX detection left unpaired in the group that holds the 100th
  slot may have been displaced by a tie at the cut, and passes if its score
  is within ``SCORE_ATOL`` of the 100th's.

Measured port-to-JAX distances on the CPU (fp32, both buckets,
``tests/test_torch_full_size_fcos.py``): the head at most 1.7e-5 of a
level's largest value unfused and 1.0e-4 with the fused flags on (the
kernels' plain versions fold FrozenBN into the convs; P3's box regression,
an ``exp``, is the largest), boxes 1.2e-4 px, scores 1.7e-6, every class and
validity equal and every slot paired; the tolerances are 5-8 x those. On the card the same rule holds
in fp32 with TF32 off and the fused kernels on (``chip_smoke.py``
``full_size``). Without ``--device`` the model runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REFERENCE = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data",
                         "fcos_r50_full_size.npz")
BUCKETS = ("landscape", "portrait")
LEVELS = ("p3", "p4", "p5", "p6", "p7")
HEAD_RTOL = 5e-4      # measured 1.0e-4 fused, 1.7e-5 unfused (CPU, fp32)
BOX_ATOL = 1e-3       # px; measured 1.2e-4
SCORE_ATOL = 1e-5     # measured 1.7e-6


def load_reference(path: str = REFERENCE) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def reference_variables(ref) -> Dict:
    from ..checkpoint.bridge import seeded_flax_variables

    return seeded_flax_variables(json.loads(str(ref["manifest"])), int(ref["weights_seed"]))


def reference_cfg(ref, dtype: str = "float32", fused: bool = True):
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(REFERENCE), "..", "..",
                                     str(ref["config"])))
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.APPROX_TOPK = False
    cfg.MODEL.RESNETS.FUSED_STEM = fused
    cfg.MODEL.RESNETS.FUSED_BLOCKS = fused
    cfg.freeze()
    return cfg


def build_reference_model(ref, variables=None, device: Optional[str] = None,
                          dtype: str = "float32", fused: bool = True):
    from ..checkpoint.bridge import load_flax_variables
    from ..models import build_model

    model = build_model(reference_cfg(ref, dtype, fused), device=device)
    load_flax_variables(model, reference_variables(ref) if variables is None else variables)
    return model


def bucket_batch(ref, bucket: str) -> Dict[str, np.ndarray]:
    """The bucket's batch of one: its seeded image, zero-padded to the bucket
    (the generator's ``bucket_batch``)."""
    (ph, pw), (h, w) = ref[f"{bucket}/pad_hw"], ref[f"{bucket}/image_hw"]
    image = np.zeros((1, int(ph), int(pw), 3), np.uint8)
    rs = np.random.RandomState(int(ref[f"{bucket}/seed"]))
    image[0, :h, :w] = rs.randint(0, 256, (int(h), int(w), 3))
    return {"image": image, "scale": np.ones((1,), np.float32),
            "orig_size": np.array([[h, w]], np.float32)}


@torch.inference_mode()
def run_bucket(model, batch) -> Dict[str, Dict[str, np.ndarray]]:
    """Head outputs (per level) and detections of one predict call."""
    dev = model.pixel_mean.device
    images = torch.as_tensor(batch["image"], device=dev)
    logits_l, reg_l, ctr_l = model(images)
    out = model.postprocess(logits_l, reg_l, ctr_l, tuple(images.shape[1:3]),
                            torch.as_tensor(batch["scale"], device=dev),
                            torch.as_tensor(batch["orig_size"], device=dev))
    heads = {"cls": [x.float().cpu().numpy() for x in logits_l],
             "reg": [x.float().cpu().numpy() for x in reg_l],
             "ctr": [x.float().reshape(x.shape[0], -1).cpu().numpy() for x in ctr_l]}
    return {"heads": heads, "dets": {k: v[0].float().cpu().numpy() if v.is_floating_point()
                                     else v[0].cpu().numpy() for k, v in out.items()}}


def head_errors(heads, ref, bucket: str) -> Dict[str, float]:
    """max |port - JAX| / max |JAX| of the sampled head entries, per level
    and output."""
    errs = {}
    for lvl, name in enumerate(LEVELS):
        key = f"{bucket}/{name}"
        loc, cls = ref[f"{key}/loc"], ref[f"{key}/class"]
        got = {"cls": heads["cls"][lvl][0, loc, cls], "reg": heads["reg"][lvl][0, loc],
               "ctr": heads["ctr"][lvl][0, loc]}
        for part, g in got.items():
            want = ref[f"{key}/{part}"].astype(np.float64)
            errs[f"{name}/{part}"] = float(np.abs(g - want).max() / np.abs(want).max())
    return errs


def _tie_groups(scores: np.ndarray, tol: float) -> List[np.ndarray]:
    """Indices of scores sorted descending, cut where neighbours differ by
    more than ``tol``."""
    order = np.argsort(-scores, kind="stable")
    groups, cur = [], [order[0]]
    for a, b in zip(order[:-1], order[1:]):
        if scores[a] - scores[b] > tol:
            groups.append(np.array(cur))
            cur = []
        cur.append(b)
    groups.append(np.array(cur))
    return groups


def match_detections(got, want, box_atol: float = BOX_ATOL,
                     score_atol: float = SCORE_ATOL) -> Dict[str, float]:
    """The rule of the module docstring. Returns the counts: ``paired``,
    ``unpaired`` (JAX detections with no partner, outside a tie at the cut),
    ``cut_ties`` (unpaired within a tie at the cut), the largest paired box
    and score distances, and ``ok``."""
    wv, gv = want["valid"].astype(bool), got["valid"].astype(bool)
    ws, gs = want["scores"][wv], got["scores"][gv]
    wb, gb = want["boxes"][wv], got["boxes"][gv]
    wc, gc = want["classes"][wv], got["classes"][gv]
    free = np.ones(len(gs), bool)
    paired = unpaired = cut_ties = 0
    box_d = score_d = 0.0
    groups = _tie_groups(ws, score_atol) if len(ws) else []
    cut = ws.min() if len(ws) else 0.0
    for group in groups:
        for i in group:
            cand = np.nonzero(free & (gc == wc[i]) & (np.abs(gs - ws[i]) <= score_atol)
                              & (np.abs(gb - wb[i]).max(-1) <= box_atol))[0]
            if len(cand):
                j = cand[np.argmin(np.abs(gs[cand] - ws[i]))]
                free[j] = False
                paired += 1
                box_d = max(box_d, float(np.abs(gb[j] - wb[i]).max()))
                score_d = max(score_d, float(abs(gs[j] - ws[i])))
            elif ws[i] - cut <= score_atol:
                cut_ties += 1
            else:
                unpaired += 1
    ok = unpaired == 0 and int(gv.sum()) == int(wv.sum())
    return {"ok": ok, "valid": int(wv.sum()), "port_valid": int(gv.sum()), "paired": paired,
            "unpaired": unpaired, "cut_ties": cut_ties, "box_dist": box_d,
            "score_dist": score_d}


def matched_share(got, want, box_atol: float, score_atol: float) -> float:
    """The share of JAX's valid slots that ``match_detections`` pairs at
    looser tolerances (a bf16 model against the fp32 reference)."""
    m = match_detections(got, want, box_atol, score_atol)
    return m["paired"] / max(m["valid"], 1)


def reference_dets(ref, bucket: str) -> Dict[str, np.ndarray]:
    return {k: ref[f"{bucket}/{k}"] for k in ("boxes", "scores", "classes", "valid")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", default=REFERENCE)
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--buckets", nargs="*", default=list(BUCKETS))
    args = ap.parse_args(argv)
    ref = load_reference(args.reference)
    model = build_reference_model(ref, device=args.device, dtype=args.dtype)
    failed = False
    for bucket in args.buckets:
        t = time.perf_counter()
        res = run_bucket(model, bucket_batch(ref, bucket))
        errs = head_errors(res["heads"], ref, bucket)
        m = match_detections(res["dets"], reference_dets(ref, bucket))
        head_ok = max(errs.values()) <= HEAD_RTOL
        failed |= not (head_ok and m["ok"])
        print(json.dumps({"bucket": bucket, "head_max_rel": max(errs.values()),
                          "head_ok": head_ok, **m,
                          "seconds": time.perf_counter() - t}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
