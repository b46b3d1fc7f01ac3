"""Add GPMP2-expert trajectories to an existing im/sdf dataset.

Port of ``dgpmp2_tpu/data/generate_paths.py`` (the reference's
``datasets/generate_optimal_paths_gpmp2.py``): for each world of a dataset
(e.g. from :mod:`dgpmp2_tpu_torch.data.generate_im`), sample start/goal
pairs, the ``diagonal`` scheme (corner to corner with jitter) or ``random``
far-apart pairs (``generate_optimal_paths_gpmp2.py:120-162``), plan them as
one batch with the fixed-covariance planner (``core.gn.plan``), re-validate
through the device lookup, and write
``opt_trajs_gpmp2/env_{i}_prob_{j}.npz``.  Draws from the caller's
``np.random.Generator`` in the JAX package's order.

    python -m dgpmp2_tpu_torch.data.generate_paths --dataset_folder d \
        --probs_per_env 2 --scheme random [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data.generate import (colliding, expert_problem,
                                            sample_start_goal)
from dgpmp2_tpu_torch.robots import PointRobot2D


def sample_diagonal(rng, n, x_lims, y_lims, jitter=0.5):
    """Corner-to-corner start/goal pairs with jitter, alternating corners."""
    lo = np.array([x_lims[0] + 1.0, y_lims[0] + 1.0])
    hi = np.array([x_lims[1] - 1.0, y_lims[1] - 1.0])
    start = np.empty((n, 2))
    goal = np.empty((n, 2))
    for j in range(n):
        if j % 2 == 0:
            s, g = lo, hi
        else:
            s, g = np.array([lo[0], hi[1]]), np.array([hi[0], lo[1]])
        start[j] = s + rng.uniform(-jitter, jitter, 2)
        goal[j] = g + rng.uniform(-jitter, jitter, 2)
    return start, goal


@torch.no_grad()
def add_expert_paths(
    subdir: str,
    probs_per_env: int,
    scheme: str,
    spec: graph.GraphSpec,
    robot,
    cfg: gn.OptimConfig,
    cov_scalars: dict,
    rng: np.random.Generator,
    label_subdir: str = "opt_trajs_gpmp2",
    max_retries: int = 30,
    device="cuda",
) -> int:
    """Label every world of ``subdir`` with ``probs_per_env`` expert plans;
    returns the number of worlds written.  A world with no collision-free
    batch after ``max_retries`` draws raises: the on-disk format needs
    ``probs_per_env`` labels for every world."""
    dev = torch.device(device)
    with open(os.path.join(subdir, "meta.yaml")) as fp:
        meta = yaml.safe_load(fp)
    num_envs = meta["num_envs"]
    im_size = meta["im_size"]
    res = (spec.x_lims[1] - spec.x_lims[0]) / im_size
    d = spec.state_dim
    written = 0
    for env_idx in range(num_envs):
        sdf_np = np.load(
            os.path.join(subdir, "im_sdf", f"{env_idx}_sdf.npy")
        ).astype(np.float32)
        # One contiguous (B, H, W) batch per world.
        sdfb = torch.as_tensor(sdf_np, device=dev).expand(
            probs_per_env, im_size, im_size).contiguous()
        for _ in range(max_retries):
            if scheme == "diagonal":
                start, goal = sample_diagonal(rng, probs_per_env,
                                              spec.x_lims, spec.y_lims)
            else:
                start, goal = sample_start_goal(rng, probs_per_env,
                                                spec.x_lims, spec.y_lims)
            startb = np.zeros((probs_per_env, d), np.float32)
            goalb = np.zeros((probs_per_env, d), np.float32)
            startb[:, :2], goalb[:, :2] = start, goal
            params, th0 = expert_problem(spec, robot, cov_scalars, startb,
                                         goalb, dev)
            result = gn.plan(spec, robot, params, th0, sdfb, cfg)
            if not colliding(spec, robot, result.th, sdfb, res).any():
                th, th0_np = result.th.cpu().numpy(), th0.cpu().numpy()
                for j in range(probs_per_env):
                    ds.save_problem(subdir, env_idx, j, label_subdir,
                                    startb[j], goalb[j], th[j], th0_np[j])
                written += 1
                break
        else:
            raise RuntimeError(
                f"env {env_idx}: no collision-free expert path after "
                f"{max_retries} retries — cannot write a uniform "
                f"probs_per_env={probs_per_env} dataset. Regenerate the env "
                "or raise max_retries."
            )
    meta["probs_per_env"] = probs_per_env
    with open(os.path.join(subdir, "meta.yaml"), "w") as fp:
        yaml.safe_dump(meta, fp)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_folder", required=True)
    p.add_argument("--mode", default="train", choices=("train", "test"))
    p.add_argument("--probs_per_env", type=int, default=1)
    p.add_argument("--scheme", default="random", choices=("random", "diagonal"))
    p.add_argument("--total_time_step", type=int, default=100)
    p.add_argument("--cost_sigma", type=float, default=0.05)
    p.add_argument("--epsilon_dist", type=float, default=0.4)
    p.add_argument("--max_iters", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    spec = graph.GraphSpec(total_time_step=args.total_time_step)
    cfg = gn.OptimConfig(reg=0.1, max_iters=args.max_iters)
    cov = dict(qc_inv=np.eye(2), cost_sigma=args.cost_sigma,
               epsilon_dist=args.epsilon_dist, k_s=0.01, k_g=0.01)
    n = add_expert_paths(
        os.path.join(os.path.abspath(args.dataset_folder), args.mode),
        args.probs_per_env, args.scheme, spec, PointRobot2D(), cfg, cov,
        np.random.default_rng(args.seed), device=args.device,
    )
    print(f"expert paths written for {n} envs")
    return n


if __name__ == "__main__":
    main()
