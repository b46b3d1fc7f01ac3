"""Build the CUDA kernels of ``dgpmp2_tpu_torch/csrc`` and bind them.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface under ``dgpmp2_tpu_torch/build/``,
loaded with ``ctypes``.  The library's file name carries a hash of the
sources and flags, so an edited source rebuilds; nvcc's ``-Xptxas -v``
report is kept beside it (``*.so.log``) and read back into ``build_log``
when the library is reused.  Nothing is built or loaded when this module is
imported.

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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# name -> argtypes; every function returns cudaGetLastError() as an int.
_SIGNATURES = {
    # (diag, off, rhs, x, gain, scratch, batch, steps, d, stream)
    "dgpmp2_btd_solve_f32": [_P] * 6 + [_I, _I, _I, _P],
    "dgpmp2_btd_solve_f64": [_P] * 6 + [_I, _I, _I, _P],
    # (d, out bytes per problem)
    "dgpmp2_btd_scratch_bytes": [_I, _P],
    # (d, batch, out int[10]): K-BTD's launch plan
    "dgpmp2_btd_plan_f32": [_I, _I, _P],
    "dgpmp2_btd_plan_f64": [_I, _I, _P],
    # (StreamArgs*, stream): ops/cuda/btd_stream._Args
    "dgpmp2_btd_stream_f32": [_P, _P],
    "dgpmp2_btd_stream_f64": [_P, _P],
    "dgpmp2_btd_stream_mixed": [_P, _P],
    # (d, batch, out int[10]): the lane-group launch plan
    **{f"dgpmp2_btd_stream_{k}_geometry": [_I, _I, _P]
       for k in ("f32", "f64", "mixed")},
    # (block, out int[5]): the wide or block kernel's attributes; (block,
    # threads, smem bytes, out int): its blocks an SM
    **{f"dgpmp2_btd_stream_{k}_rows_attrs": [_I, _P]
       for k in ("f32", "f64", "mixed")},
    **{f"dgpmp2_btd_stream_{k}_rows_occupancy": [_I, _I, _I, _P]
       for k in ("f32", "f64", "mixed")},
    # (cap) -> the previous cap
    "dgpmp2_btd_stream_set_producers": [_I],
    # (plan, sdf, points, out, stream); plan: ops/cuda/_tiles.LookupPlan.
    "dgpmp2_sdf_lookup_f32": [_P] * 5,
    "dgpmp2_sdf_lookup_f64": [_P] * 5,
    "dgpmp2_sdf_lookup3d_f32": [_P] * 5,
    "dgpmp2_sdf_lookup3d_f64": [_P] * 5,
    **{f"dgpmp2_sdf_lookup_limbs_l{n}": [_P] * 5 for n in (1, 2, 3)},
    # (plan, sdf, points, d_bar, g_bar, p_bar, s_bar or NULL, stream)
    **{f"dgpmp2_sdf_lookup{nd}_bwd_f{bits}": [_P] * 8
       for nd in ("", "3d") for bits in (32, 64)},
    # (x, gamma, beta, out, batch, depth, height, width, channels, ndim,
    #  pool, eps, stream)
    **{f"dgpmp2_encoder_norm_f{bits}": [_P] * 4 + [_I] * 7 + [_D, _P]
       for bits in (32, 64)},
    # (x, gamma, beta, gout, dx, partial, blocks, batch, depth, height,
    #  width, channels, ndim, pool, eps, stream)
    **{f"dgpmp2_encoder_norm_bwd_f{bits}": [_P] * 6 + [_I] * 8 + [_D, _P]
       for bits in (32, 64)},
}

_lib = None
build_log = ""  # nvcc's stderr of the library's compile (ptxas register counts)


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
    cu = [s for s in _sources() if s.suffix == ".cu"]
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{s.stem}.o") for s in cu]
    tmp = out.with_name(f"{tag}.so.tmp")
    nvcc = find_nvcc()
    steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
             for s, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in steps]
    logs = [p.communicate()[1] for p in procs]
    failed = [(c, p.returncode, e) for c, p, e in zip(steps, procs, logs)
              if p.returncode != 0]
    try:
        if not failed:
            link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = [(link, proc.returncode, proc.stderr)]
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    if failed:
        cmd, rc, err = failed[0]
        raise RuntimeError(
            f"kernel build failed (exit {rc}): {' '.join(cmd)}\n{err}")
    build_log = "".join(logs)
    _log_path(out).write_text(build_log)
    os.replace(tmp, out)


def _log_path(lib: Path) -> Path:
    return lib.with_name(f"{lib.name}.log")


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use and loaded once per process."""
    global _lib, build_log
    if _lib is None:
        path = _library_path()
        if not path.is_file():
            _compile(path)
        elif _log_path(path).is_file():
            build_log = _log_path(path).read_text()
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
