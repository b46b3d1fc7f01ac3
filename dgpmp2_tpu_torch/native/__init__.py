"""ctypes binding of the package's native C++ host runtime
(``dgpmp2_tpu_torch/csrc/dgpmp2_native.cpp``, a copy of the JAX package's
``csrc/dgpmp2_native.cpp``).

Port of ``dgpmp2_tpu/native/__init__.py``: the exact host EDT / SDF of the
data pipeline and the RRT* expert planner that stands in for the reference's
OMPL dependency (``diff_gpmp2/ompl_rrtstar.py``).

At first use the source is compiled by ``g++`` into
``dgpmp2_tpu_torch/build/libdgpmp2_native_<hash>.so``, the hash over the
source and the flags, so an edited source rebuilds.  Nothing is built or
loaded when this module is imported.  There is no fallback: a missing
``g++`` or a failed build raises, naming the command and its stderr, and
every entry point needs the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "csrc" / "dgpmp2_native.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libdgpmp2_native_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH; the native runtime of dgpmp2_tpu_torch "
            f"is built from {SRC} and has no fallback")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The native library, compiled on first use and loaded once per
    process."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.edt_2d_sq.argtypes = [u8, f32, ctypes.c_int, ctypes.c_int]
        lib.edt_2d_sq.restype = None
        lib.sdf_2d.argtypes = [u8, f32, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float]
        lib.sdf_2d.restype = None
        lib.rrt_star_2d.argtypes = [
            f32, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint64,
            f32, ctypes.c_int,
        ]
        lib.rrt_star_2d.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a probe: the entry points
    raise instead)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def edt_sq(mask: np.ndarray) -> np.ndarray:
    """Exact squared EDT (pixels²) of an (H, W) mask to its nearest True
    cell, float32."""
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    h, w = mask.shape
    out = np.empty((h, w), np.float32)
    load().edt_2d_sq(mask, out, h, w)
    return out


def sdf_2d(free_mask: np.ndarray, res: float) -> np.ndarray:
    """Signed distance field (metres, float32) of an (H, W) free-space mask,
    as :func:`dgpmp2_tpu_torch.ops.sdf.sdf_from_occupancy` computes it:
    ``(edt(occupied) - edt(free)) * res`` with a one-pixel free border."""
    free_mask = np.ascontiguousarray(np.asarray(free_mask).astype(np.uint8))
    h, w = free_mask.shape
    out = np.empty((h, w), np.float32)
    load().sdf_2d(free_mask, out, h, w, float(res))
    return out


def rrt_star(
    sdf: np.ndarray,
    start,
    goal,
    x_lims,
    y_lims,
    clearance: float,
    plan_time: float = 2.0,
    max_iters: int = 20000,
    seed: int = 0,
    max_waypoints: int = 512,
) -> Optional[np.ndarray]:
    """RRT* path (S, 2) float32 from ``start`` to ``goal`` on an (H, W) SDF,
    or None when the search finds none (also when an endpoint is itself
    invalid).

    The reference's ``RRTStar.plan`` (``ompl_rrtstar.py:12-50``): a state is
    valid where ``sdf(x) > clearance``; the search stops after ``max_iters``
    samples or ``plan_time`` seconds, whichever comes first, so it is
    deterministic in ``seed`` only when ``max_iters`` binds.
    """
    lib = load()
    sdf = np.ascontiguousarray(np.asarray(sdf, np.float32))
    h, w = sdf.shape
    out = np.empty((max_waypoints, 2), np.float32)
    n = lib.rrt_star_2d(
        sdf, h, w,
        float(x_lims[0]), float(x_lims[1]), float(y_lims[0]), float(y_lims[1]),
        float(start[0]), float(start[1]), float(goal[0]), float(goal[1]),
        float(clearance), float(plan_time), int(max_iters), int(seed),
        out.reshape(-1), max_waypoints,
    )
    if n <= 0:
        return None
    return out[:n].copy()


def interpolate_path(path: np.ndarray, num_states: int) -> np.ndarray:
    """Arc-length resample a waypoint path (S, 2) to ``num_states`` points
    (OMPL's ``path.interpolate``, ``ompl_rrtstar.py:41-46``), float64."""
    seg = np.linalg.norm(np.diff(path, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1] if s[-1] > 0 else 1.0
    tq = np.linspace(0.0, total, num_states)
    x = np.interp(tq, s, path[:, 0])
    y = np.interp(tq, s, path[:, 1])
    return np.stack([x, y], axis=-1)
