"""Watch a directory for new prediction files and evaluate each (counterpart
of ``tools/watch_evaluate.py``: the same flags): every
``*coco_instances_results*.json`` under ``--watch-dir`` without a
``.evaluated`` marker is evaluated by this package's ``result_statistic``
in a subprocess; a run that exits 0 writes the marker.

    python -m slenderobjdet_torch.tools.watch_evaluate --watch-dir outputs/ \\
        --gt-json instances.json [--interval 30] [--once]

Host only: no model and no card.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--watch-dir", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--pattern", default="*coco_instances_results*.json")
    ap.add_argument("--interval", type=float, default=30.0)
    ap.add_argument("--once", action="store_true", help="single scan (no polling loop)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    """Returns the prediction files evaluated, each with its exit code
    (the loop returns only with ``--once``)."""
    args = parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    seen, done = set(), []
    while True:
        for path in sorted(glob.glob(os.path.join(args.watch_dir, "**", args.pattern),
                                     recursive=True)):
            marker = path + ".evaluated"
            if path in seen or os.path.exists(marker):
                continue
            seen.add(path)
            cmd = [sys.executable, "-m", "slenderobjdet_torch.tools.result_statistic",
                   "--prediction", path, "--gt-json", args.gt_json]
            print("evaluating:", " ".join(cmd), flush=True)
            rc = subprocess.call(cmd, env=env)
            if rc == 0:
                with open(marker, "w") as f:
                    f.write("ok\n")
            done.append((path, rc))
        if args.once:
            return done
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
