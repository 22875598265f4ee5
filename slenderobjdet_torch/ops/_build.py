"""Build and load the port's CUDA kernels, and count their launches.

The sources under ``csrc/`` are compiled by ``nvcc``, one process a source,
all started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds. The library is built at first use into
``build/torch_kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources, the headers they include
and the compiler command, so an edit to any of them rebuilds it and an
unchanged tree reuses it.

Each kernel wrapper adds one to its entry of ``LAUNCHES`` where it launches
its kernel, and nowhere else; a run shows which kernels it went through by
resetting the counts before and reading them after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nms.cu", "fused_stem.cu", "fused_bottleneck.cu",
           "dma_streams_probe.cu", "bw_probe.cu", "rotated.cu", "corner_pool.cu")
HEADERS = ("hopper.cuh",)     # included by the sources, not compiled alone
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libslenderobjdet_kernels.so"
# Hopper only: sm_90a, the target that also admits wgmma and setmaxnreg.
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {"nms": 0, "fused_stem": 0, "fused_bottleneck": 0,
                            "fused_kernel_probe": 0, "dma_streams_probe": 0,
                            "bw_probe": 0, "rotated_iou": 0, "rotated_nms": 0,
                            "corner_pool": 0}

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nms_launch": [_P, _P, _P, _I, _P, _P, _I, _I, ctypes.c_float, _I, _P, _P, _P,
                   _P],
    "nms_smem_bytes": [_I, _I],
    "fused_stem_cuda_core_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_stem_cuda_core_smem_bytes": [_I],
    "fused_stem_mma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_bottleneck_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv_wgmma_launch": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _P],
    "dma_streams_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bw_probe_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
    "rotated_corners_launch": [_P, _I, _P, _P, _P],
    "rotated_iou_launch": [_P, _P, _P, _P, _I, _I, _P, _P],
    "rotated_nms_smem_bytes": [_I],
    "rotated_nms_scratch_bytes": [_I, _I],
    "rotated_nms_launch": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P],
    "corner_pool_forward_scratch_bytes": [_I, _I, _I, _I, _I],
    "corner_pool_forward_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "corner_pool_backward_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_RESTYPES = {"corner_pool_forward_scratch_bytes": ctypes.c_longlong}   # else int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def nvcc_commands(output: str, nvcc: str = "nvcc") -> Tuple[List[List[str]], List[str]]:
    """The commands that build the kernel library into ``output``: one
    compile a source into an object beside ``output``, then the link."""
    objects = [f"{output}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-c", "-o", obj, str(CSRC / s)] for s, obj in zip(SOURCES, objects)]
    return compiles, [nvcc, *ARCH_FLAGS, "-shared", "-o", output, *objects]


def hashed_files() -> List[Path]:
    """Every file under ``csrc/`` a build reads: each ``*.cu`` and ``*.cuh``."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _source_hash() -> str:
    compiles, link = nvcc_commands("out")
    h = hashlib.sha256(" ".join(sum(compiles, []) + link).encode())
    for path in hashed_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernel library unless this tree's build already exists."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    compiles, link = nvcc_commands(str(tmp), nvcc_path())
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in compiles]
    try:
        for cmd, proc in zip([*compiles, link], [*procs, None]):
            if proc is None:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")
        os.replace(tmp, path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for cmd in compiles:
            Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper takes CUDA tensors on one device, or raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all tensors must be on one CUDA device, got "
                f"{[str(u.device) for u in tensors]}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    return DTYPE_CODES[dtype]
