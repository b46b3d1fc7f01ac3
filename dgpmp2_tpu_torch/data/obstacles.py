"""Procedural obstacle-map generation (host-side, numpy).

Port of ``dgpmp2_tpu/data/obstacles.py``, numpy only: the five environment
families of the reference's ``datasets/generate_2d_dataset.py:26-88``
(``tar_pit``, ``forest``, ``multi_obs``, ``passage``, ``mixed_clutter``) by
rejection sampling that keeps obstacles apart (``patch_obs``) and off the
start/goal clearance patches (``patch_pts``).  Every draw from the
``np.random.Generator`` is made in the JAX package's order and shape, so one
seed gives the same maps in both packages.

Map convention: float array, 1.0 = free, 0.0 = obstacle.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

FAMILIES = ("tar_pit", "forest", "multi_obs", "passage", "mixed_clutter")


def _add_rect(occ, cy, cx, h, w, pad=0):
    h2, w2 = math.ceil(h / 2) + math.ceil(pad / 2), math.ceil(w / 2) + math.ceil(pad / 2)
    occ[max(0, int(cy - h2)) : int(cy + h2), max(0, int(cx - w2)) : int(cx + w2)] += 1
    return occ


def _add_point(occ, pt, patch):
    p2 = math.ceil(patch / 2)
    y, x = int(math.ceil(pt[1])), int(math.ceil(pt[0]))
    occ[max(0, y - p2) : y + p2, max(0, x - p2) : x + p2] += 1
    return occ


def _rect_valid(occ, cy, cx, h, w, pts, patch_pts, patch_obs):
    test = _add_rect(occ.copy(), cy, cx, h, w, pad=patch_obs)
    if np.any(test > 1):
        return False
    if pts is not None:
        base = _add_rect(occ.copy(), cy, cx, h, w)
        for pt in pts:
            if np.any(_add_point(base.copy(), pt, patch_pts) > 1):
                return False
    return True


def rect_obstacle_map(
    rng: np.random.Generator,
    im_size: int,
    num_obst: int,
    pts: Optional[Sequence] = None,
    w_range=(4, 12),
    h_range=(4, 12),
    region=None,
    patch_pts: int = 0,
    patch_obs: int = 0,
    max_tries: int = 200,
):
    """Random axis-aligned boxes with rejection sampling.

    ``region`` = (x0, y0, x1, y1) pixel bounds for obstacle centers.
    """
    x0, y0, x1, y1 = region or (0, 0, im_size - 1, im_size - 1)
    occ = np.zeros((im_size, im_size))
    placed = 0
    tries = 0
    while placed < num_obst and tries < max_tries:
        tries += 1
        w = int(rng.integers(w_range[0], w_range[1] + 1))
        h = int(rng.integers(h_range[0], h_range[1] + 1))
        lo_x, hi_x = x0 + math.ceil(w / 2), x1 - math.ceil(w / 2)
        lo_y, hi_y = y0 + math.ceil(h / 2), y1 - math.ceil(h / 2)
        if hi_x <= lo_x or hi_y <= lo_y:
            continue
        cx = int(rng.integers(lo_x, hi_x + 1))
        cy = int(rng.integers(lo_y, hi_y + 1))
        if _rect_valid(occ, cy, cx, h, w, pts, patch_pts, patch_obs):
            occ = _add_rect(occ, cy, cx, h, w)
            placed += 1
    return 1.0 - np.clip(occ, 0, 1)


def wall_obstacle_map(
    rng: np.random.Generator,
    im_size: int,
    pts: Optional[Sequence] = None,
    w_range=(8, 18),
    gap_range=(8, 12),
    start_x: int = 0,
    patch_pts: int = 0,
    max_tries: int = 200,
):
    """A vertical wall spanning the map with one gap
    (``obst_generator.py:84-127``)."""
    occ0 = np.zeros((im_size, im_size))
    for _ in range(max_tries):
        w = int(rng.integers(w_range[0], w_range[1] + 1))
        gw = int(rng.integers(gap_range[0], gap_range[1] + 1))
        cx = int(rng.integers(start_x + math.ceil(w / 2), im_size - math.ceil(w / 2)))
        gy = int(rng.integers(math.ceil(gw / 2), im_size - math.ceil(gw / 2)))
        occ = occ0.copy()
        xlo, xhi = cx - math.ceil(w / 2), cx + math.ceil(w / 2)
        occ[0 : gy - math.ceil(gw / 2), xlo:xhi] += 1
        occ[gy + math.ceil(gw / 2) :, xlo:xhi] += 1
        ok = True
        if pts is not None:
            for pt in pts:
                if np.any(_add_point(occ.copy(), pt, patch_pts) > 1):
                    ok = False
                    break
        if ok:
            return 1.0 - np.clip(occ, 0, 1)
    return 1.0 - np.clip(occ0, 0, 1)


def make_map(
    family: str,
    rng: np.random.Generator,
    im_size: int,
    pts=None,
    patch_pts: int = 0,
    patch_obs: int = 0,
):
    """Sample one obstacle map of the given family
    (``generate_2d_dataset.py:29-88`` parameterizations)."""
    if family == "tar_pit":
        n = int(rng.integers(5, 8))
        w = im_size // 10
        s = int(0.15 * im_size)
        return rect_obstacle_map(
            rng, im_size, n, pts, (w, w + 1), (w, w + 1),
            region=(s, s, s + im_size // 2, s + im_size // 2),
            patch_pts=patch_pts, patch_obs=patch_obs,
        )
    if family == "forest":
        n = int(rng.integers(23, 45))
        w = max(2, im_size // 30)
        return rect_obstacle_map(
            rng, im_size, n, pts, (w, w + 1), (w, w + 1),
            patch_pts=patch_pts, patch_obs=patch_obs,
        )
    if family == "multi_obs":
        n = int(rng.integers(2, 5))
        w = im_size // 8
        s = int(0.1 * im_size)
        return rect_obstacle_map(
            rng, im_size, n, pts, (w, w + 10), (w, w + 10),
            region=(s, s, im_size - s, im_size - s),
            patch_pts=patch_pts, patch_obs=patch_obs,
        )
    if family == "passage":
        return wall_obstacle_map(
            rng, im_size, pts,
            w_range=(im_size // 5, im_size // 5 + 10),
            gap_range=(max(4, patch_obs), max(4, patch_obs) + 1),
            start_x=int(0.15 * im_size), patch_pts=patch_pts,
        )
    if family == "mixed_clutter":
        sub = FAMILIES[int(rng.integers(0, 3))]
        return make_map(sub, rng, im_size, pts, patch_pts, patch_obs)
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
