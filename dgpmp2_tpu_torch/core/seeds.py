"""Informed (RRT*) seed trajectories for multistart planning.

Port of ``dgpmp2_tpu/core/seeds.py``, numpy only.  GPMP2 is a local
optimiser; on dense clutter a pool of sine-harmonic perturbations of the
straight-line seed (``core.multistart``) may reach no collision-free basin.
The reference seeds GPMP2 with an RRT* path (its dataset generator's
``rrt_star_traj``); here the repo's native RRT* (:mod:`dgpmp2_tpu_torch.native`)
plans one coarse path per problem on the host, which is arc-length resampled
to the T+1 support states and given the constant average velocity (the
reference's ``ompl_rrtstar.py:41-46`` interpolation and
``utils/planner_utils.py:60-71`` ``path_to_traj_avg_vel``).  The (B, T+1,
2·dof) batch goes to :func:`dgpmp2_tpu_torch.core.multistart.plan_multistart`
as one row of ``extra_seeds``; planning and selection stay on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from dgpmp2_tpu_torch import native


def path_to_traj_avg_vel(path: np.ndarray, total_time_sec: float,
                         num_states: int) -> np.ndarray:
    """Waypoint path (S, dof) -> trajectory (num_states, 2·dof) float32:
    arc-length resampled positions and the constant average velocity."""
    pos = native.interpolate_path(np.asarray(path, np.float64), num_states)
    avg_vel = (pos[-1] - pos[0]) / float(total_time_sec)
    vel = np.broadcast_to(avg_vel, pos.shape)
    return np.concatenate([pos, vel], axis=-1).astype(np.float32)


def rrt_seed_batch(
    sdf_batch: np.ndarray,
    starts: np.ndarray,
    goals: np.ndarray,
    x_lims: Tuple[float, float],
    y_lims: Tuple[float, float],
    total_time_sec: float,
    num_states: int,
    clearance: float,
    plan_time: float = 1.0,
    max_iters: int = 20000,
    seed=0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-problem RRT* seed trajectories for a (B, H, W) SDF batch.

    Returns ``(seeds (B, num_states, 4) float32, found (B,) bool)``.  A
    problem whose search finds no path gets the straight-line trajectory
    with the average velocity, the multistart base seed, so its row is a
    harmless duplicate in the pool.  A missing native library raises.

    ``clearance`` is the validity threshold ``sdf(x) > clearance`` (the
    robot radius, plus a margin if wanted).  ``seed`` is the RRT* seed of
    every problem, or a (B,) sequence of one per problem: a problem's seed
    does not depend on its place in the batch unless the caller makes it so
    (the JAX package salts it with the row index, ``seed + i``).  Host-side
    and sequential over B.
    """
    sdf_batch = np.asarray(sdf_batch, np.float32)
    starts = np.asarray(starts, np.float32)
    goals = np.asarray(goals, np.float32)
    b = sdf_batch.shape[0]
    row_seeds = np.broadcast_to(np.asarray(seed, np.int64), (b,))
    seeds = np.empty((b, num_states, 4), np.float32)
    found = np.zeros((b,), bool)
    for i in range(b):
        path = native.rrt_star(
            sdf_batch[i], starts[i, :2], goals[i, :2], x_lims, y_lims,
            clearance=clearance, plan_time=plan_time, max_iters=max_iters,
            seed=int(row_seeds[i]),
        )
        if path is None or len(path) < 2:
            path = np.stack([starts[i, :2], goals[i, :2]])
        else:
            found[i] = True
        seeds[i] = path_to_traj_avg_vel(path, total_time_sec, num_states)
    return seeds, found
