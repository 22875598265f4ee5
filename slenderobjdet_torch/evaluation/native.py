"""ctypes loader for the native slender-eval matching kernel.

Builds csrc/slender_eval.c with the system C compiler at first use into
``build/slender_eval/<hash of the source>/_slender_eval.so`` at the
repository root (listed in ``.gitignore``; never beside the source), so an
edit to the source rebuilds it. Where no C compiler exists `available()` is
false and callers keep the pure-numpy path, which computes the same
matches; `backend()` says which of the two a run takes. A copy of
``slenderobjdet_tpu/evaluation/native.py`` apart from where it builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "slender_eval.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slender_eval"

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / "_slender_eval.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode == 0:
                os.replace(tmp, so)
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists() and not _build(so):
                return None
            lib = ctypes.CDLL(str(so))
            fn = lib.slender_match_pair
            fn.restype = None
            fn.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ] + [ctypes.c_void_p] * 15
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """"c" where the C matcher built and loaded, else "numpy"."""
    return "c" if available() else "numpy"


def match_pair(iou_thrs, rng_lo, rng_hi, ious, gt_ratio, gt_crowd,
               gt_ignore_base, gt_ids, dt_ids, dt_ratio):
    """One (image, category) pair, all ranges x thresholds at once.

    Returns (dtm (A,T,D), gtm (A,T,G), dt_ig (A,T,D), gt_ig (A,G),
    gt_order (A,G)) exactly as slender_cocoeval.evaluateImg computes them
    (gt-side arrays in the per-range ignore-sorted order)."""
    lib = _load()
    assert lib is not None
    T, A = len(iou_thrs), len(rng_lo)
    D, G = len(dt_ids), len(gt_ids)
    assert G <= 4096, "native matcher supports <= 4096 gt per (img, cat)"

    c = np.ascontiguousarray
    iou_thrs = c(iou_thrs, np.float64)
    rng_lo = c(rng_lo, np.float64)
    rng_hi = c(rng_hi, np.float64)
    ious = c(ious, np.float64).reshape(D, G)
    gt_ratio = c(gt_ratio, np.float64)
    gt_crowd = c(gt_crowd, np.uint8)
    gt_ignore_base = c(gt_ignore_base, np.uint8)
    gt_ids = c(gt_ids, np.int64)
    dt_ids = c(dt_ids, np.int64)
    dt_ratio = c(dt_ratio, np.float64)

    dtm = np.zeros((A, T, D), np.float64)
    gtm = np.zeros((A, T, G), np.float64)
    dt_ig = np.zeros((A, T, D), np.uint8)
    gt_ig = np.zeros((A, G), np.uint8)
    gt_order = np.zeros((A, G), np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.slender_match_pair(
        T, A, D, G,
        p(iou_thrs), p(rng_lo), p(rng_hi), p(ious), p(gt_ratio),
        p(gt_crowd), p(gt_ignore_base), p(gt_ids), p(dt_ids), p(dt_ratio),
        p(dtm), p(gtm), p(dt_ig), p(gt_ig), p(gt_order),
    )
    return dtm, gtm, dt_ig, gt_ig, gt_order
