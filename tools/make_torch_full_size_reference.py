#!/usr/bin/env python
"""Write the JAX package's FCOS R-50-FPN outputs at the loader's full size,
which the PyTorch port is held to (``tests/test_torch_full_size_fcos.py`` on
the CPU, ``chip_smoke.py``'s ``full_size`` phase on the card).

The model is ``configs/fcos/fcos_R_50_FPN_1x.yaml`` in float32 with exact
top-k, at B = 1 in both padded buckets of ``data/mapper.py``: 896 x 1408
(an 800 x 1333 image) and 1408 x 896 (1333 x 800). Its weights are drawn in
numpy by the port's ``checkpoint/bridge.py:seeded_flax_variables`` from the
manifest that ``jax.eval_shape`` of the JAX init gives, so that a machine
without JAX rebuilds them; each image is a seeded uint8 array, zero-padded to
its bucket.

The file holds the manifest, the seeds, the weights' checksum, and per bucket
the 100 detections (boxes, scores, classes, valid) and a seeded sample of
the head per FPN level: ``SAMPLE`` locations (every location of a smaller
level), one seeded class each; its cls logit, its 4 box regressions and its
centerness.

    python tools/make_torch_full_size_reference.py [--out tests/data/fcos_r50_full_size.npz]

It runs JAX on the CPU (about 3 minutes and 6 GB) and only here: the card's
machine has no JAX.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from slenderobjdet_torch.checkpoint.bridge import (manifest_of,  # noqa: E402
                                                   seeded_flax_variables,
                                                   variables_checksum)
from slenderobjdet_tpu.config import get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model  # noqa: E402

CONFIG = "configs/fcos/fcos_R_50_FPN_1x.yaml"
WEIGHTS_SEED = 20
SAMPLE_SEED = 21
BUCKETS = {"landscape": {"pad_hw": (896, 1408), "image_hw": (800, 1333), "seed": 22},
           "portrait": {"pad_hw": (1408, 896), "image_hw": (1333, 800), "seed": 23}}
SAMPLE = 4096


def init_rule(name, shape):
    """The leaf's draw: He-normal kernels, FrozenBN scales in [0.75, 1.25]
    with small biases, zero biases (the cls bias too: the focal prior would
    keep every score under the threshold), unit norm and level scales."""
    leaf = name.rsplit("/", 1)[-1]
    if name.startswith("buffers/"):
        return {"scale": "frozen_bn_scale", "bias": "frozen_bn_bias"}[leaf]
    return {"kernel": "he_normal", "bias": "zeros", "scale": "ones"}[leaf]


def full_size_cfg(get_cfg_fn):
    cfg = get_cfg_fn()
    cfg.merge_from_file(CONFIG)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.freeze()
    return cfg


def bucket_batch(bucket):
    """The bucket's batch of one: the seeded image, zero-padded (as
    ``slenderobjdet_torch/tools/full_size_check.py:bucket_batch`` draws it
    from the file)."""
    spec = BUCKETS[bucket]
    (ph, pw), (h, w) = spec["pad_hw"], spec["image_hw"]
    image = np.zeros((1, ph, pw, 3), np.uint8)
    image[0, :h, :w] = np.random.RandomState(spec["seed"]).randint(0, 256, (h, w, 3))
    return {"image": image, "scale": np.ones((1,), np.float32),
            "orig_size": np.array([[h, w]], np.float32)}


def head_sample(counts, num_classes, bucket):
    """Per level: sorted location indices (all of a level of at most
    SAMPLE) and one class each, from SAMPLE_SEED and the bucket."""
    rs = np.random.RandomState(SAMPLE_SEED + list(BUCKETS).index(bucket))
    out = []
    for n in counts:
        loc = np.sort(rs.choice(n, SAMPLE, replace=False)) if n > SAMPLE else np.arange(n)
        out.append((loc.astype(np.int32), rs.randint(0, num_classes, len(loc)).astype(np.int32)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/data/fcos_r50_full_size.npz")
    args = ap.parse_args()
    cfg = full_size_cfg(get_cfg)
    det = build_model(cfg)
    shapes = jax.eval_shape(det.init_variables, jax.random.PRNGKey(0))
    manifest = manifest_of(shapes, init_rule)
    variables = seeded_flax_variables(manifest, WEIGHTS_SEED)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    file = {"manifest": np.array(json.dumps(manifest)),
            "checksum": np.array(variables_checksum(variables)),
            "weights_seed": np.array(WEIGHTS_SEED), "sample_seed": np.array(SAMPLE_SEED),
            "config": np.array(CONFIG)}
    predict = jax.jit(det.predict)
    heads = jax.jit(lambda v, x: det.module.apply(v, x, train=False))
    for bucket, spec in BUCKETS.items():
        t = time.time()
        batch = bucket_batch(bucket)
        dets = predict(jvars, {k: jnp.asarray(v) for k, v in batch.items()})
        logits_l, reg_l, ctr_l = heads(jvars, jnp.asarray(batch["image"]))
        counts = [int(x.shape[1]) for x in logits_l]
        for lvl, (loc, cls) in enumerate(head_sample(counts, cfg.MODEL.FCOS.NUM_CLASSES,
                                                     bucket)):
            key = f"{bucket}/p{lvl + 3}"
            file[f"{key}/loc"], file[f"{key}/class"] = loc, cls
            file[f"{key}/cls"] = np.asarray(logits_l[lvl])[0, loc, cls]
            file[f"{key}/reg"] = np.asarray(reg_l[lvl])[0, loc]
            file[f"{key}/ctr"] = np.asarray(ctr_l[lvl]).reshape(1, -1)[0, loc]
        for k in ("boxes", "scores", "classes", "valid"):
            file[f"{bucket}/{k}"] = np.asarray(dets[k])[0]
        file[f"{bucket}/seed"] = np.array(spec["seed"])
        file[f"{bucket}/pad_hw"] = np.array(spec["pad_hw"])
        file[f"{bucket}/image_hw"] = np.array(spec["image_hw"])
        print(f"{bucket}: {int(np.sum(file[f'{bucket}/valid']))} valid detections, "
              f"levels {counts}, {time.time() - t:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **file)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
