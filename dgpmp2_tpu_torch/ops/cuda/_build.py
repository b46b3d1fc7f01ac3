"""Build the CUDA kernels of ``dgpmp2_tpu_torch/csrc`` and bind them.

At first use, every ``csrc/*.cu`` is compiled by one ``nvcc`` call for
``sm_90a`` into a shared library with a plain C interface, under
``dgpmp2_tpu_torch/build/``, and loaded with ``ctypes``.  The library's file
name carries a hash of the sources and flags, so an edited source rebuilds.
Nothing is built or loaded when this module is imported.

There is no fallback: a missing ``nvcc`` or a failed build raises, naming the
command and its stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_double
# name -> argtypes; every function returns cudaGetLastError() as an int.
_SIGNATURES = {
    "dgpmp2_btd_solve_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dgpmp2_btd_solve_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dgpmp2_sdf_lookup_f32": [_P, _P, _P, _P, _I, _I, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "dgpmp2_sdf_lookup_f64": [_P, _P, _P, _P, _I, _I, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "dgpmp2_sdf_lookup3d_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                *[_F] * 11, _I, _P],
    "dgpmp2_sdf_lookup3d_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                *[_F] * 11, _I, _P],
    "dgpmp2_sdf_lookup_limbs": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                *[_F] * 8, _P],
}

_lib = None
build_log = ""  # nvcc's stderr of the last compile (ptxas register counts)


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of dgpmp2_tpu_torch are built from csrc/*.cu and have no fallback"
    )


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdgpmp2_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_log
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log = proc.stderr


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use and loaded once per process."""
    global _lib
    if _lib is None:
        path = _library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")
