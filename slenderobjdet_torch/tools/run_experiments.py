"""Queue a family of configs through ``train_net_torch.py`` with dated output
directories, ``--resume`` and bounded retries (counterpart of
``tools/run_experiments.py``: the same flags and commands, with this
package's entry script in place of ``train_net.py``).

    python -m slenderobjdet_torch.tools.run_experiments --model fcos \\
        [--depths 18 34 50 101] [--schedule 1x] [--retries 3] [--dry-run] \\
        [--opts KEY VAL ...]
    python -m slenderobjdet_torch.tools.run_experiments --configs a.yaml b.yaml --model custom

Each run is a local subprocess, started from the repository root, whose
output directory is ``output/<MM-DD>_<model>_<backbone>_<schedule>``; a
failed run is retried (``--resume`` continues it from its last checkpoint)
``--retries`` times. The runs train on the card, as ``train_net_torch.py``
does by default.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
from typing import List, Optional

FAMILIES = ("fcos", "retina", "faster", "rep-points")
ENTRY = "train_net_torch.py"


def output_dir(model_name: str, backbone: str, schedule: str) -> str:
    today = datetime.date.today()
    return "output/{:02d}-{:02d}_{}_{}_{}".format(
        today.month, today.day, model_name, backbone, schedule)


def build_commands(model, configs, backbones, schedule, opts):
    cmds = []
    for backbone, cfg_file in zip(backbones, configs):
        out = output_dir(model, backbone, schedule)
        cmds.append([sys.executable, ENTRY, "--resume",
                     "--config-file", cfg_file, "OUTPUT_DIR", out] + list(opts))
    return cmds


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True,
                    help=f"family name ({'/'.join(FAMILIES)}) or a label for --configs")
    ap.add_argument("--depths", type=int, nargs="+", default=[50, 101, 152])
    ap.add_argument("--configs", nargs="+", default=None,
                    help="explicit config list (overrides the family sweep)")
    ap.add_argument("--schedule", default="1x")
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--retry-wait", type=float, default=10.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="print the commands without running")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                    help="extra config overrides appended to every run")
    return ap, ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the commands and those that failed after every retry."""
    ap, args = parse_args(argv)
    if args.configs:
        configs = args.configs
        backbones = [os.path.splitext(os.path.basename(c))[0] for c in configs]
    else:
        if args.model not in FAMILIES:
            ap.error(f"--model must be one of {FAMILIES} unless --configs is given")
        configs = [f"configs/group_exp_for_backbone/{args.model}/r-{d}.yaml"
                   for d in args.depths]
        backbones = [f"R_{d}_FPN" for d in args.depths]

    cmds = build_commands(args.model, configs, backbones, args.schedule, args.opts)
    failed = []
    for cmd in cmds:
        print(" ".join(cmd), flush=True)
        if args.dry_run:
            continue
        for attempt in range(args.retries):
            ret = subprocess.call(cmd)
            if ret == 0:
                break
            print(f"exit {ret} for {' '.join(cmd)}; retry "
                  f"{attempt + 1}/{args.retries} in {args.retry_wait}s "
                  "(resumes from the last checkpoint)", flush=True)
            time.sleep(args.retry_wait)
        else:
            failed.append(" ".join(cmd))
    if failed:
        print("FAILED after retries:\n  " + "\n  ".join(failed), flush=True)
    return {"commands": cmds, "failed": failed}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
