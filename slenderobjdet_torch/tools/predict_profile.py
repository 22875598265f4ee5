"""Staged device-time profile of FCOS predict: forward / +candidates / +NMS
(counterpart of ``tools/predict_profile.py``: the same flags, sizes and
lines).

    python -m slenderobjdet_torch.tools.predict_profile [--batch 32] [--reps 32]
        [--device cuda|cpu]

The flagship FCOS R-50-FPN (``configs/fcos/fcos_R_50_FPN_1x.yaml``, bf16,
the fused flags off as the yaml leaves them) with weights drawn from seed 0,
on B uint8 zero images of 800 x 1344. Stages: ``fwd`` the network
(``FCOSModule.forward``); ``fwd+cand`` the network and the per-level
candidates (``FCOS.candidates``: threshold, exact top-k, decode); ``full``
``FCOS.predict``, which launches the NMS kernel once a call. Each stage is
called once and then ``--reps`` times back to back (``tools/_profile.py``);
the first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import torch

from ._profile import (StageTimer, add_device_arg, device_line, device_of, load_cfg,
                       predict_batch, seeded_model)

CONFIG = "configs/fcos/fcos_R_50_FPN_1x.yaml"
OVERRIDES: List[str] = []           # KEY VALUE pairs over the yaml
HW = (800, 1344)


def stages(model, batch) -> Dict[str, Callable[[], object]]:
    """The timed stages, in the JAX script's order."""
    img = batch["image"]
    hw = tuple(img.shape[1:3])
    return {
        "fwd": lambda: model(img),
        "fwd+cand": lambda: model.candidates(*model(img), hw),
        "full": lambda: model.predict(batch),
    }


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(device_line(dev), flush=True)
    B = args.batch

    model = seeded_model(load_cfg(CONFIG, OVERRIDES), dev)
    timer = StageTimer(dev, args.reps)
    for name, fn in stages(model, predict_batch(B, HW, dev)).items():
        ms = timer(name, fn)
        print(f"{name:10s} {ms:8.2f} ms  ({B / ms * 1e3:.1f} img/s)", flush=True)
    return timer.result()


if __name__ == "__main__":
    main()
