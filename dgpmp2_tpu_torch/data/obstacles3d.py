"""Procedural 3-D voxel obstacle worlds (host-side, numpy).

Port of ``dgpmp2_tpu/data/obstacles3d.py``, numpy only, the 3-D companion of
:mod:`dgpmp2_tpu_torch.data.obstacles`: float grids, 1.0 = free, 0.0 =
obstacle, rejection sampling that keeps obstacles apart (``patch_obs``) and
off the start/goal clearance patches (``patch_pts``).  Grids are indexed
``[z, row, col]`` as ``ops/sdf.py:trilinear_lookup`` reads them.  Every draw
is made in the JAX package's order and shape.

Families:
  ``boxes3d``    — few large axis-aligned boxes (multi_obs in 3-D).
  ``scatter3d``  — many small cubes (forest in 3-D).
  ``window``     — a full-cross-section wall pierced by one rectangular
                   window (passage in 3-D).
  ``columns``    — full-height pillars: 2-D forest geometry extruded in z.
  ``mixed3d``    — random mix of the above.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

FAMILIES3D = ("boxes3d", "scatter3d", "window", "columns", "mixed3d")


def _add_box(occ, c, half, pad=0):
    """Accumulate a box centered at voxel c = (z, y, x) with half-extents
    ``half = (hz, hy, hx)`` (+pad/2 on every side)."""
    sl = tuple(
        slice(max(0, int(ci - hi - math.ceil(pad / 2))),
              int(ci + hi + math.ceil(pad / 2)))
        for ci, hi in zip(c, half)
    )
    occ[sl] += 1
    return occ


def _add_point(occ, pt_zyx, patch):
    p2 = math.ceil(patch / 2)
    sl = tuple(slice(max(0, int(math.ceil(p)) - p2), int(math.ceil(p)) + p2)
               for p in pt_zyx)
    occ[sl] += 1
    return occ


def _box_valid(occ, c, half, pts_zyx, patch_pts, patch_obs):
    test = _add_box(occ.copy(), c, half, pad=patch_obs)
    if np.any(test > 1):
        return False
    if pts_zyx is not None:
        base = _add_box(occ.copy(), c, half)
        for pt in pts_zyx:
            if np.any(_add_point(base.copy(), pt, patch_pts) > 1):
                return False
    return True


def box_obstacle_map3d(
    rng: np.random.Generator,
    size: int,
    num_obst: int,
    pts_zyx: Optional[Sequence] = None,
    ext_range=(4, 10),
    region=None,
    patch_pts: int = 0,
    patch_obs: int = 0,
    full_height: bool = False,
    max_tries: int = 200,
):
    """(size, size, size) world with ``num_obst`` random boxes.

    ``region`` restricts centers to (lo, hi) per axis; ``full_height``
    extrudes every box through the whole z extent (the ``columns``
    family).  Boxes that cannot be placed after ``max_tries`` rejection
    draws are dropped (matching the 2-D generator's behavior on dense
    maps).
    """
    occ = np.zeros((size, size, size), np.int32)
    lo, hi = (0, size) if region is None else region
    for _ in range(num_obst):
        for _t in range(max_tries):
            c = rng.integers(lo, hi, 3)
            half = rng.integers(ext_range[0], ext_range[1], 3) // 2
            if full_height:
                c[0] = size // 2
                half[0] = size  # clipped by the slice bounds
            if _box_valid(occ, c, half, pts_zyx, patch_pts, patch_obs):
                occ = _add_box(occ, c, half)
                break
    return (occ == 0).astype(np.float64)


def window_map3d(
    rng: np.random.Generator,
    size: int,
    pts_zyx: Optional[Sequence] = None,
    thick_range=None,
    win_range=None,
    patch_pts: int = 0,
):
    """A wall filling the full x-z cross-section at a random y, pierced by
    one rectangular window at a random (z, x) — the 3-D passage."""
    thick_range = thick_range or (size // 6, size // 6 + 4)
    win_range = win_range or (max(6, patch_pts), max(6, patch_pts) + 3)
    for _ in range(200):
        occ = np.zeros((size, size, size), np.int32)
        y0 = int(rng.integers(int(0.3 * size), int(0.7 * size)))
        t = int(rng.integers(*thick_range))
        occ[:, y0 : y0 + t, :] = 1
        wz = int(rng.integers(*win_range))
        wx = int(rng.integers(*win_range))
        cz = int(rng.integers(wz, size - wz))
        cx = int(rng.integers(wx, size - wx))
        occ[cz - wz // 2 : cz + (wz + 1) // 2, y0 : y0 + t,
            cx - wx // 2 : cx + (wx + 1) // 2] = 0
        if pts_zyx is not None:
            base = occ.copy()
            if any(np.any(_add_point(base.copy(), pt, patch_pts) > 1)
                   for pt in pts_zyx):
                continue
        return (occ == 0).astype(np.float64)
    # Dense clearance patches: fall back to a wall with a centered window.
    occ = np.zeros((size, size, size), np.int32)
    y0, t = size // 2, thick_range[0]
    occ[:, y0 : y0 + t, :] = 1
    w = win_range[1]
    c = size // 2
    occ[c - w : c + w, y0 : y0 + t, c - w : c + w] = 0
    return (occ == 0).astype(np.float64)


def make_map3d(
    family: str,
    rng: np.random.Generator,
    size: int,
    pts_zyx=None,
    patch_pts: int = 0,
    patch_obs: int = 0,
):
    """Sample one voxel world of the given family (parameterizations scaled
    from the 2-D families of ``generate_2d_dataset.py:29-88``)."""
    # Free volume grows CUBICALLY with size — obstacle counts must scale
    # with volume (scatter) or cross-section (columns), not linearly,
    # or larger worlds trivialize (runs/plan3d saturation note).
    vol = (size / 32.0) ** 3
    area = (size / 32.0) ** 2
    if family == "boxes3d":
        n = int(rng.integers(3, 7) * vol)
        w = size // 6
        s = int(0.1 * size)
        return box_obstacle_map3d(
            rng, size, n, pts_zyx, (w, w + 6),
            region=(s, size - s), patch_pts=patch_pts, patch_obs=patch_obs,
        )
    if family == "scatter3d":
        n = int(rng.integers(30, 60) * vol)
        w = max(3, size // 14)
        return box_obstacle_map3d(
            rng, size, n, pts_zyx, (w, w + 2),
            patch_pts=patch_pts, patch_obs=patch_obs,
        )
    if family == "window":
        return window_map3d(rng, size, pts_zyx, patch_pts=patch_pts)
    if family == "columns":
        n = int(rng.integers(10, 20) * area)
        w = max(3, size // 12)
        return box_obstacle_map3d(
            rng, size, n, pts_zyx, (w, w + 3), patch_pts=patch_pts,
            patch_obs=patch_obs, full_height=True,
        )
    if family == "mixed3d":
        sub = FAMILIES3D[int(rng.integers(0, 4))]
        return make_map3d(sub, rng, size, pts_zyx, patch_pts, patch_obs)
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES3D}")
