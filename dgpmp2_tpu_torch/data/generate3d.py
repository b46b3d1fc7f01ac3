"""3-D planning dataset generation: voxel worlds and batched expert plans.

Port of ``dgpmp2_tpu/data/generate3d.py``, the 3-D companion of
:mod:`dgpmp2_tpu_torch.data.generate`: worlds from :mod:`obstacles3d` with
start/goal clearance patches, the SDF built on the device
(``ops.sdf.sdf_from_occupancy_3d``), the problems of a world planned as one
batch by the LM planner with ``track_best``, every label re-validated
through the device lookup (``ops.sdf.lookup_nd``), a colliding world
redrawn whole, and the 2-D layout's twin on disk: ``im_sdf/{i}_vox.npy`` +
``{i}_sdf.npy`` and ``opt_trajs_gpmp2/env_{i}_prob_{j}.npz``, read by
:func:`load_split3d`.  Draws from the caller's ``np.random.Generator`` in
the JAX package's order.

  python -m dgpmp2_tpu_torch.data.generate3d --out /tmp/d3 --family boxes3d \
      --num_envs 8 --probs 4 --size 48 --t 30 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import obstacles3d
from dgpmp2_tpu_torch.data.generate import colliding, expert_problem
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PointRobot3D

DEFAULT_COV = dict(qc_inv=np.eye(3), cost_sigma=0.05, epsilon_dist=0.4,
                   k_s=0.01, k_g=0.01)


def sample_start_goal_3d(rng, n, lims):
    """Opposite-corner-region start/goal pairs (n, 3), every axis's role
    swapped at random per problem."""
    lo, hi = lims
    span = hi - lo
    s = rng.uniform(lo + 0.04 * span, lo + 0.16 * span, (n, 3))
    g = rng.uniform(hi - 0.16 * span, hi - 0.04 * span, (n, 3))
    flip = rng.random((n, 3)) < 0.5
    s2 = np.where(flip, g, s)
    g2 = np.where(flip, s, g)
    return s2, g2


def world_to_vox_zyx(pts_xyz, lims, res):
    """(N, 3) world (x, y, z) -> (N, 3) fractional (z, row, col) indices:
    **zyx order**, the (D, H, W) indexing that ``obstacles3d`` carves."""
    lo, _ = lims
    out = np.empty_like(pts_xyz)
    out[:, 0] = -lo / res + pts_xyz[:, 2] / res          # z -> depth
    out[:, 1] = -lo / res - pts_xyz[:, 1] / res          # y -> row (flip)
    out[:, 2] = -lo / res + pts_xyz[:, 0] / res          # x -> col
    return out


@torch.no_grad()
def generate_split3d(
    out_dir: str,
    num_envs: int,
    probs_per_env: int,
    family: str,
    size: int,
    rng: np.random.Generator,
    t: int = 30,
    lims=(-5.0, 5.0),
    cov_scalars: Optional[dict] = None,
    max_iters: int = 40,
    label_subdir: str = "opt_trajs_gpmp2",
    max_env_retries: int = 20,
    device="cuda",
) -> dict:
    """Write ``num_envs`` voxel worlds of ``probs_per_env`` LM-expert
    labels under ``out_dir``; returns the run's counts, ``attempts``
    (worlds drawn) and ``plans`` (one per attempt).  ``max_env_retries``
    redraws in a row raise."""
    dev = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    cov_scalars = dict(DEFAULT_COV, **(cov_scalars or {}))
    robot = PointRobot3D()
    spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                           x_lims=lims, y_lims=lims, z_lims=lims)
    cfg = gn.OptimConfig(reg=0.1, max_iters=max_iters, method="lm")
    res = (lims[1] - lims[0]) / size
    safety = float(cov_scalars["epsilon_dist"]) + robot.sphere_radii[0]
    patch_pts = int(np.ceil((safety + robot.sphere_radii[0]) / res))
    patch_obs = {"boxes3d": 2 * patch_pts, "scatter3d": patch_pts,
                 "window": 0, "columns": patch_pts,
                 "mixed3d": patch_pts}[family]
    stats = dict(attempts=0, plans=0)

    env_idx = 0
    while env_idx < num_envs:
        for _ in range(max_env_retries):
            stats["attempts"] += 1
            start, goal = sample_start_goal_3d(rng, probs_per_env, lims)
            pts_zyx = world_to_vox_zyx(np.concatenate([start, goal]), lims,
                                       res)
            vox = obstacles3d.make_map3d(family, rng, size, pts_zyx,
                                         patch_pts, patch_obs)
            sdf = sdf_ops.sdf_from_occupancy_3d(
                torch.as_tensor(vox, dtype=torch.float32, device=dev),
                res=res)
            d = spec.state_dim
            startb = np.zeros((probs_per_env, d), np.float32)
            goalb = np.zeros((probs_per_env, d), np.float32)
            startb[:, :3], goalb[:, :3] = start, goal
            params, th0 = expert_problem(spec, robot, cov_scalars, startb,
                                         goalb, dev)
            sdfb = sdf.expand(probs_per_env, size, size, size).contiguous()
            result = gn.plan(spec, robot, params, th0, sdfb, cfg,
                             track_best=True)
            stats["plans"] += 1
            if colliding(spec, robot, result.best_th, sdfb, res).any():
                continue  # redraw the world (3-D worlds are cheap)
            th, th0_np = result.best_th.cpu().numpy(), th0.cpu().numpy()
            imsdf = os.path.join(out_dir, "im_sdf")
            os.makedirs(imsdf, exist_ok=True)
            np.save(os.path.join(imsdf, f"{env_idx}_vox.npy"),
                    vox.astype(np.float32))
            np.save(os.path.join(imsdf, f"{env_idx}_sdf.npy"),
                    sdf.cpu().numpy())
            lab = os.path.join(out_dir, label_subdir)
            os.makedirs(lab, exist_ok=True)
            for j in range(probs_per_env):
                np.savez(os.path.join(lab, f"env_{env_idx}_prob_{j}"),
                         start=startb[j], goal=goalb[j], th_opt=th[j],
                         th_init=th0_np[j])
            env_idx += 1
            break
        else:
            raise RuntimeError(
                f"no collision-free {family} env after {max_env_retries} "
                "tries")
    with open(os.path.join(out_dir, "meta.yaml"), "w") as fp:
        yaml.safe_dump({"num_envs": num_envs,
                        "probs_per_env": probs_per_env, "size": size,
                        "family": family, "dim": 3, "t": t,
                        "lims": list(lims)}, fp)
    return stats


def load_split3d(root: str):
    """Yield (vox, sdf, start, goal, th_opt, th_init) per problem."""
    with open(os.path.join(root, "meta.yaml")) as fp:
        meta = yaml.safe_load(fp)
    for i in range(meta["num_envs"]):
        vox = np.load(os.path.join(root, "im_sdf", f"{i}_vox.npy"))
        sdf = np.load(os.path.join(root, "im_sdf", f"{i}_sdf.npy"))
        for j in range(meta["probs_per_env"]):
            z = np.load(os.path.join(root, "opt_trajs_gpmp2",
                                     f"env_{i}_prob_{j}.npz"))
            yield vox, sdf, z["start"], z["goal"], z["th_opt"], z["th_init"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--family", default="boxes3d",
                   choices=list(obstacles3d.FAMILIES3D))
    p.add_argument("--num_envs", type=int, default=8)
    p.add_argument("--probs", type=int, default=4)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--t", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    generate_split3d(args.out, args.num_envs, args.probs, args.family,
                     args.size, np.random.default_rng(args.seed), t=args.t,
                     device=args.device)
    print(f"[generate3d] wrote {args.num_envs} envs x {args.probs} to "
          f"{args.out}")


if __name__ == "__main__":
    main()
