"""ctypes loader for the native border-map renderer (csrc/border_render.c).

Builds the source with the system C compiler at first use into
``build/border_render/<hash of the source>/_border_render.so`` at the
repository root (listed in ``.gitignore``; never beside the source), so an
edit to the source rebuilds it. Where no compiler builds it, `available()`
is false, the failure is logged once with the compilers' messages, and
``BorderMasks`` renders with numpy, which computes the same maps;
`backend()` says which of the two a run takes. A copy of
``slenderobjdet_tpu/structures/native.py`` apart from where it builds and
that it says so when it cannot.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "border_render.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "border_render"

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / "_border_render.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode == 0:
                os.replace(tmp, so)
                return True
            errors.append(f"{cc}: {r.stderr.strip()}")
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
    logger.warning("border_render.c did not build (%s); BorderMasks renders "
                   "with numpy", "; ".join(errors))
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
            lib.render_instance_maps.restype = ctypes.c_int
            lib.render_instance_maps.argtypes = (
                [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double]
                + [ctypes.c_void_p] * 3
            )
            lib.render_center_score.restype = ctypes.c_int
            lib.render_center_score.argtypes = (
                [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                   ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
            )
            _lib = lib
        except OSError as e:
            logger.warning("border_render library did not load (%s); "
                           "BorderMasks renders with numpy", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """"c" where the renderer built and loaded, else "numpy"."""
    return "c" if available() else "numpy"


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def render_instance_maps(hull: np.ndarray, o, dilate_dist: float,
                         window, border: np.ndarray, center: np.ndarray,
                         sizes: np.ndarray) -> bool:
    """Render one instance into the full-image float32 maps in place.
    window = (x0, y0, x1, y1), pre-clipped. Returns False if the kernel
    declined (hull too large): the caller falls back to numpy."""
    lib = _load()
    if lib is None:
        return False
    hull = np.ascontiguousarray(hull, np.float64)
    x0, y0, x1, y1 = window
    ok = lib.render_instance_maps(
        hull.shape[0], x0, y0, x1, y1, border.shape[1],
        _ptr(hull), float(o[0]), float(o[1]), float(dilate_dist),
        _ptr(border), _ptr(center), _ptr(sizes))
    return bool(ok)


def render_center_score(hull: np.ndarray, o, standard: str, sigma: float,
                        window, out: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    hull = np.ascontiguousarray(hull, np.float64)
    x0, y0, x1, y1 = window
    ok = lib.render_center_score(
        hull.shape[0], x0, y0, x1, y1, out.shape[1],
        _ptr(hull), float(o[0]), float(o[1]),
        0 if standard == "linear" else 1, float(sigma), _ptr(out))
    return bool(ok)
