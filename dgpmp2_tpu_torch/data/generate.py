"""Dataset generation: procedural worlds and GPMP2-expert trajectories.

Port of ``dgpmp2_tpu/data/generate.py`` (the reference's
``datasets/generate_2d_dataset.py``): sample far-apart start/goal pairs,
draw an obstacle map from a family, build its SDF on the device, plan the
problems of each world as one batch with the fixed-covariance planner as
the expert (``core.gn.plan`` with ``track_best``), re-validate every label
for collisions through the device lookup (``ops.sdf.lookup``), salvage the
problems that fail, and write the reference's on-disk layout
(``data/dataset.py``).

Sampling and rejection stay on the host in numpy, drawing from the caller's
``np.random.Generator`` in the JAX package's order and shapes through every
retry and salvage, so one seed gives the same worlds, starts and goals in
both packages.  The device is read once per world (its SDF) and once per
plan (the accept/reject decision).

CLI (``--device cpu`` plans on the CPU):
    python -m dgpmp2_tpu_torch.data.generate --out_folder d \
        --dataset_type forest --num_train 50 --num_test 10 --probs_per_env 2
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data import obstacles
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

DIST_FACTOR = 0.6  # min start-goal separation as a fraction of the diagonal


def sample_start_goal(rng, n, x_lims, y_lims):
    """Far-apart start/goal pairs (n, 2), rejected per pair."""
    lo = np.array([x_lims[0] + 1.0, y_lims[0] + 1.0])
    hi = np.array([x_lims[1] - 1.0, y_lims[1] - 1.0])
    diag = np.hypot(x_lims[1] - x_lims[0], y_lims[1] - y_lims[0])
    start = rng.uniform(lo, hi, size=(n, 2))
    goal = rng.uniform(lo, hi, size=(n, 2))
    while True:
        bad = np.linalg.norm(goal - start, axis=-1) < DIST_FACTOR * diag
        if not np.any(bad):
            return start, goal
        k = int(bad.sum())
        start[bad] = rng.uniform(lo, hi, size=(k, 2))
        goal[bad] = rng.uniform(lo, hi, size=(k, 2))


def world_to_pix(pts, x_lims, y_lims, res):
    """(N, 2) world (x, y) -> (N, 2) fractional (col, row) pixels."""
    out = np.empty_like(pts)
    out[:, 0] = -x_lims[0] / res + pts[:, 0] / res
    out[:, 1] = -y_lims[0] / res - pts[:, 1] / res
    return out


def expert_problem(spec, robot, cov_scalars, startb, goalb, device):
    """float32 fixed-covariance params and straight-line seeds on
    ``device`` for (B, D) numpy start and goal states."""
    start = torch.as_tensor(startb, dtype=torch.float32, device=device)
    goal = torch.as_tensor(goalb, dtype=torch.float32, device=device)
    params = graph.default_params(spec, robot, start, goal, **cov_scalars,
                                  dtype=torch.float32)
    th0 = straight_line_traj(start[:, :spec.dof], goal[:, :spec.dof],
                             spec.total_time_sec, spec.total_time_step)
    return params, th0


def colliding(spec, robot, th, sdfb, res):
    """(B,) numpy bool: a state of ``th`` within the robot radius of an
    obstacle, read through the device lookup (one host read)."""
    z_lims = spec.z_lims
    dists, _ = sdf_ops.lookup_nd(sdfb, th[..., :spec.dof], res, spec.x_lims,
                                 spec.y_lims, z_lims)
    return (torch.amin(dists, dim=-1) <= robot.sphere_radii[0]).cpu().numpy()


def _patches(family, res, robot, cov_scalars):
    """(safety, patch_pts, patch_obs) of a family, in metres and pixels."""
    safety = float(cov_scalars["epsilon_dist"]) + robot.sphere_radii[0]
    patch_safety = int(np.ceil(safety / res))
    patch_robot = int(np.ceil(robot.sphere_radii[0] / res))
    patch_pts = {
        "tar_pit": patch_robot + 2 * patch_safety,
        "forest": 3 * patch_robot,
        "multi_obs": patch_safety + patch_robot,
        "passage": 3 * patch_robot,
        "mixed_clutter": int(0.8 * patch_safety),
    }[family]
    patch_obs = {
        "tar_pit": 0,
        "forest": 3 * patch_robot,
        "multi_obs": 2 * (patch_robot + patch_safety),
        "passage": 4 * patch_robot,
        "mixed_clutter": 2 * (patch_robot + patch_safety),
    }[family]
    return safety, patch_pts, patch_obs


def _rrt_seeds(rng, sdf_np, start, goal, spec, safety, stats):
    """One RRT* seed per problem, or None at the first problem whose search
    finds no path (the seeds drawn from ``rng`` up to it); counts the
    searches and the paths found into ``stats``."""
    seeds = []
    for j in range(len(start)):
        path = native.rrt_star(
            sdf_np, start[j], goal[j], spec.x_lims, spec.y_lims,
            clearance=safety, plan_time=2.0,
            seed=int(rng.integers(1 << 31)),
        )
        stats["rrt_searches"] += 1
        if path is None:
            return None
        stats["rrt_found"] += 1
        interp = native.interpolate_path(path, spec.num_traj_states)
        vel = (interp[-1] - interp[0]) / float(spec.total_time_sec)
        seeds.append(np.concatenate(
            [interp, np.broadcast_to(vel, interp.shape)], axis=-1))
    return np.stack(seeds).astype(np.float32)


@torch.no_grad()
def generate_split(
    out_dir: str,
    num_envs: int,
    probs_per_env: int,
    family: str,
    im_size: int,
    rng: np.random.Generator,
    spec: graph.GraphSpec,
    robot,
    cfg: gn.OptimConfig,
    cov_scalars: dict,
    label_subdir: str = "opt_trajs_gpmp2",
    max_env_retries: int = 20,
    rrtstar_init: bool = False,
    device="cuda",
) -> dict:
    """Write ``num_envs`` worlds of ``probs_per_env`` expert-labelled
    problems under ``out_dir``; returns the run's counts: ``attempts``
    (worlds drawn), ``plans`` (expert plans of B = ``probs_per_env``),
    ``problems`` (start/goal pairs planned for the first time, fresh worlds'
    and salvaged ones), ``rrt_searches`` and ``rrt_found`` (with
    ``rrtstar_init``).

    A world whose labels collide has its failing pairs resampled against
    the same map, up to 6 times, before it is redrawn (no salvage with
    ``rrtstar_init``); ``max_env_retries`` redraws in a row raise.
    """
    dev = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    res = (spec.x_lims[1] - spec.x_lims[0]) / im_size
    safety, patch_pts, patch_obs = _patches(family, res, robot, cov_scalars)
    d = spec.state_dim
    stats = dict(attempts=0, plans=0, problems=0, rrt_searches=0,
                 rrt_found=0)

    env_idx = 0
    while env_idx < num_envs:
        for _ in range(max_env_retries):
            stats["attempts"] += 1
            start, goal = sample_start_goal(rng, probs_per_env, spec.x_lims,
                                            spec.y_lims)
            pts = np.concatenate([
                world_to_pix(start, spec.x_lims, spec.y_lims, res),
                world_to_pix(goal, spec.x_lims, spec.y_lims, res),
            ])
            im = obstacles.make_map(family, rng, im_size, pts, patch_pts,
                                    patch_obs)
            sdf = sdf_ops.sdf_from_occupancy(
                torch.as_tensor(im, dtype=torch.float32, device=dev), res=res)
            sdf_np = sdf.cpu().numpy()
            startb = np.zeros((probs_per_env, d), np.float32)
            goalb = np.zeros((probs_per_env, d), np.float32)
            startb[:, :2], goalb[:, :2] = start, goal
            params, th0 = expert_problem(spec, robot, cov_scalars, startb,
                                         goalb, dev)
            if rrtstar_init:
                # RRT* seeds from the native planner (the reference's OMPL
                # bridge, generate_2d_dataset.py:90-100).
                seeds = _rrt_seeds(rng, sdf_np, start, goal, spec, safety,
                                   stats)
                if seeds is None:
                    continue
                th0 = torch.as_tensor(seeds, device=dev)
            # One contiguous (B, H, W) batch per world, for every plan and
            # re-validation of it.
            sdfb = sdf.expand(probs_per_env, im_size, im_size).contiguous()
            # Per-problem salvage: resample only the pairs whose labels
            # collide, against the same map (feasibility-checked on its
            # SDF), instead of rejecting the world (generate_2d_dataset.py
            # :247-265 with a tighter retry target).
            salvage_tries = 0 if rrtstar_init else 6
            stats["problems"] += probs_per_env
            ok = False
            for salvage in range(salvage_tries + 1):
                result = gn.plan(spec, robot, params, th0, sdfb, cfg,
                                 track_best=True)
                stats["plans"] += 1
                bad = colliding(spec, robot, result.best_th, sdfb, res)
                if not bad.any():
                    ok = True
                    break
                if salvage == salvage_tries:
                    break
                nb = int(bad.sum())
                for _feas in range(50):
                    s_new, g_new = sample_start_goal(rng, nb, spec.x_lims,
                                                     spec.y_lims)
                    pix = world_to_pix(np.concatenate([s_new, g_new]),
                                       spec.x_lims, spec.y_lims, res)
                    ij = np.clip(np.rint(pix).astype(int), 0, im_size - 1)
                    if np.all(sdf_np[ij[:, 1], ij[:, 0]] > safety + res):
                        break
                else:
                    break  # map too dense to place pairs: redraw the world
                stats["problems"] += nb
                startb[bad, :2], goalb[bad, :2] = s_new, g_new
                startb[bad, 2:] = 0.0
                goalb[bad, 2:] = 0.0
                params, th0 = expert_problem(spec, robot, cov_scalars,
                                             startb, goalb, dev)
            if not ok:
                continue
            th = result.best_th.cpu().numpy()
            th0_np = th0.cpu().numpy()
            ds.save_env(out_dir, env_idx, im, sdf_np)
            for j in range(probs_per_env):
                ds.save_problem(out_dir, env_idx, j, label_subdir, startb[j],
                                goalb[j], th[j], th0_np[j])
            env_idx += 1
            break
        else:
            raise RuntimeError(
                f"could not generate a collision-free env after "
                f"{max_env_retries} tries")
    ds.save_meta(out_dir, num_envs, probs_per_env, im_size,
                 extra={"family": family,
                        "x_lims": list(spec.x_lims),
                        "y_lims": list(spec.y_lims)})
    return stats


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_folder", type=str, required=True)
    p.add_argument("--dataset_type", type=str, default="forest",
                   choices=obstacles.FAMILIES)
    p.add_argument("--im_size", type=int, default=128)
    p.add_argument("--num_train", type=int, default=50)
    p.add_argument("--num_test", type=int, default=10)
    p.add_argument("--probs_per_env", type=int, default=1)
    p.add_argument("--seed_val", type=int, default=0)
    p.add_argument("--total_time_step", type=int, default=100)
    p.add_argument("--cost_sigma", type=float, default=0.05)
    p.add_argument("--epsilon_dist", type=float, default=0.4)
    p.add_argument("--max_iters", type=int, default=60)
    p.add_argument("--rrtstar_init", action="store_true",
                   help="seed the expert with native RRT* paths")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    spec = graph.GraphSpec(total_time_step=args.total_time_step)
    robot = PointRobot2D()
    cfg = gn.OptimConfig(reg=0.1, max_iters=args.max_iters)
    cov_scalars = dict(qc_inv=np.eye(2), cost_sigma=args.cost_sigma,
                       epsilon_dist=args.epsilon_dist, k_s=0.01, k_g=0.01)
    rng = np.random.default_rng(args.seed_val)
    out = os.path.abspath(args.out_folder)
    for mode, n in (("train", args.num_train), ("test", args.num_test)):
        if n > 0:
            generate_split(
                os.path.join(out, mode), n, args.probs_per_env,
                args.dataset_type, args.im_size, rng, spec, robot, cfg,
                cov_scalars, rrtstar_init=args.rrtstar_init,
                device=args.device,
            )
    print(f"dataset written to {out}")


if __name__ == "__main__":
    main()
