"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each source in ``repro_torch/csrc/`` is compiled on first use into its own
shared library with a plain C interface, all sources at once (one ``nvcc``
process each, started together); a source may hold the entry points of
several kernels.  The libraries land in
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a hash
of the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  A failed build raises with the compiler's
output.  Nothing here runs at import time: the CPU tests import every
module on machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    "bound_grid": ("bound_grid.cu", "bound_grid_launch",
                   [_P] * 8 + [_I] * 5 + [_P] * 3),
    "hausdorff_grid": ("hausdorff_grid.cu", "hausdorff_lanes_launch",
                       [_P] * 7 + [_I] * 6 + [_P] * 2),
    "min_sq_dists": ("min_sq_dists.cu", "min_sq_dists_pairs_launch",
                     [_P] * 4 + [_I] * 4 + [_P] * 2),
    "set_intersect": ("set_intersect.cu", "set_intersect_launch",
                      [_P] * 2 + [_I] * 3 + [_P] * 2),
    "nn_distance": ("nn_distance.cu", "nn_distance_batched_launch",
                    [_P] * 4 + [_I] * 4 + [_P] * 3),
    "bound_matrices": ("bound_matrices.cu", "bound_matrices_launch",
                       [_P] * 4 + [_I] * 4 + [_P] * 3),
    "bound_row_ub": ("bound_matrices.cu", "bound_row_ub_launch",
                     [_P] * 5 + [_I] * 4 + [_P] * 2),
}

#: the sources, each built once into ``lib<stem>.so``
SOURCES = sorted({src for src, _, _ in KERNELS.values()})

#: launches per kernel: each wrapper adds one where it launches its kernel,
#: and nowhere else (``repro_torch.kernels.ops.LAUNCHES`` is this dict)
LAUNCHES = {name: 0 for name in KERNELS}

_fns: dict = {}
_libs: list = []          # keeps the loaded libraries alive
#: guards the first build and load, and the launch counts: a server's
#: dispatcher thread and the caller's thread may both use the kernels
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds spent (0 when everything was built)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [(src, _lib_path(src)) for src in SOURCES
            if not _lib_path(src).exists()]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def _lib_path(src: str) -> Path:
    return build_dir() / f"lib{Path(src).stem}.so"


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, built on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            build_all()
            src, sym, argtypes = KERNELS[name]
            lib = ctypes.CDLL(str(_lib_path(src)))
            _libs.append(lib)
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def launched(name: str, rc: int) -> None:
    """Raise on a failed launch, else count it."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _lock:
        LAUNCHES[name] += 1
