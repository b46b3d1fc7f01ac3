"""3-D planner quality sweep: static sigma sensitivity + multistart across
the five voxel families.

Port of the JAX package's ``tools/plan3d_sweep.py`` (the 2-D campaign
protocol of ``data/sensitivity.py`` / ``multistart_sweep``, one dimension
up; the reference is planar).  Per family: generate a seeded test set
(``data.generate3d`` worlds, no expert labels: judging is geometric), plan
every problem from the straight seed at each sigma, then compose the best
sigma with K-restart multistart, and report solve (margin-clear),
contact-free and GP-smoothness rates as a markdown table.

Usage:
  python -m dgpmp2_tpu_torch.tools.plan3d_sweep --out runs/plan3d \\
      --envs 20 --probs 4 [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph, multistart
from dgpmp2_tpu_torch.data import obstacles3d
from dgpmp2_tpu_torch.data.generate3d import (sample_start_goal_3d,
                                              world_to_vox_zyx)
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PointRobot3D
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import dump_yaml, straight

LIMS = (-5.0, 5.0)
SIGMAS = (0.01, 0.02, 0.05, 0.1, 0.2)
EPS = 0.4


def make_problems(family, envs, probs, size, seed, device="cuda",
                  dtype=torch.float32):
    """Voxel worlds + start/goal batches (feasibility-patched): the (B, D,
    H, W) SDF batch on ``device`` in ``dtype`` (built in float32, as the
    datasets are), (B, 3) numpy starts and goals, and the resolution."""
    rng = np.random.default_rng(seed)
    res = LIMS[1] * 2 / size
    robot = PointRobot3D()
    patch = int(np.ceil((EPS + 2 * robot.sphere_radii[0]) / res))
    sdfs, starts, goals = [], [], []
    for _ in range(envs):
        s, g = sample_start_goal_3d(rng, probs, LIMS)
        pts = world_to_vox_zyx(np.concatenate([s, g]), LIMS, res)
        vox = obstacles3d.make_map3d(family, rng, size, pts, patch, patch)
        sdf = sdf_ops.sdf_from_occupancy_3d(
            torch.as_tensor(vox, dtype=torch.float32, device=device), res=res)
        sdfs.append(sdf.expand(probs, *sdf.shape))
        starts.append(s)
        goals.append(g)
    return (torch.cat(sdfs).to(dtype).contiguous(), np.concatenate(starts),
            np.concatenate(goals), res)


@torch.no_grad()
def judge(spec, robot, th, sdf, res):
    """Geometric judging: contact-free (radius-clear interior) and solve
    (clears radius + half the safety margin, the canonical-margin rule
    scaled to 3-D), and the mean squared velocity; numpy (B,) each."""
    d, _ = sdf_ops.lookup_nd(sdf, th[..., :3].contiguous(), res, LIMS, LIMS,
                             LIMS)
    di = d[:, 1:-1]
    r = robot.sphere_radii[0]
    contact_free = (torch.amin(di, dim=-1) > r).cpu().numpy()
    solve = (torch.amin(di, dim=-1) > r + 0.5 * EPS).cpu().numpy()
    v = th[..., 3:]
    smooth = torch.mean(torch.sum(v**2, -1), -1).cpu().numpy()
    return solve, contact_free, smooth


def rates(solve, cf, sm) -> dict:
    return {"solve_rate": float(solve.mean()),
            "contact_free_rate": float(cf.mean()),
            "avg_vel_mse": float(sm.mean())}


def table(results: dict, args) -> str:
    lines = [
        f"# 3-D planner sweep — {args.envs} envs x {args.probs} problems "
        f"per family, {args.size}³ voxels, T={args.t}, LM 50 iters",
        "",
        f"Regenerate: `python -m dgpmp2_tpu_torch.tools.plan3d_sweep --out "
        f"{args.out} --envs {args.envs} --probs {args.probs} --size "
        f"{args.size} --seed {args.seed}`",
        "",
        "| family | best static (sigma) | solve | contact-free | "
        f"+ms{args.restarts} solve | +ms contact-free |",
        "|---|---|---|---|---|---|",
    ]
    for fam, rows in results.items():
        bs = rows["best_static"]
        m = rows[f"ms{args.restarts}"]
        lines.append(
            f"| {fam} | {bs['sigma']} | {bs['solve_rate']:.3f} | "
            f"{bs['contact_free_rate']:.3f} | **{m['solve_rate']:.3f}** | "
            f"{m['contact_free_rate']:.3f} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--envs", type=int, default=20)
    p.add_argument("--probs", type=int, default=4)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--t", type=int, default=30)
    p.add_argument("--restarts", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype
    os.makedirs(args.out, exist_ok=True)

    robot = PointRobot3D()
    spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=args.t,
                           x_lims=LIMS, y_lims=LIMS, z_lims=LIMS)
    cfg = gn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    results = {}
    for family in obstacles3d.FAMILIES3D:
        sdfb, s, g, res = make_problems(family, args.envs, args.probs,
                                        args.size, args.seed, dev, dtype)
        b = sdfb.shape[0]
        startb = torch.zeros((b, 6), dtype=dtype, device=dev)
        goalb = torch.zeros((b, 6), dtype=dtype, device=dev)
        startb[:, :3] = torch.as_tensor(s, dtype=dtype, device=dev)
        goalb[:, :3] = torch.as_tensor(g, dtype=dtype, device=dev)
        th0 = straight(spec, startb, goalb)
        fam_rows, best = {}, None
        for sigma in SIGMAS:
            params = graph.default_params(
                spec, robot, startb, goalb, qc_inv=np.eye(3),
                cost_sigma=sigma, epsilon_dist=EPS, k_s=0.01, k_g=0.01,
                dtype=dtype)
            with torch.no_grad():
                out = gn.plan(spec, robot, params, th0, sdfb, cfg,
                              track_best=True)
            row = rates(*judge(spec, robot, out.best_th, sdfb, res))
            fam_rows[f"sigma_{sigma}"] = row
            print(f"[{family}] sigma={sigma}: solve={row['solve_rate']:.3f} "
                  f"cf={row['contact_free_rate']:.3f}", flush=True)
            if best is None or row["solve_rate"] > best[1]["solve_rate"]:
                best = (sigma, row, params)
        sigma_b, row_b, params_b = best
        with torch.no_grad():
            ms = multistart.plan_multistart(
                spec, robot, params_b, th0, sdfb, cfg,
                torch.Generator(dev).manual_seed(args.seed),
                restarts=args.restarts, amp=2.0, prune_iters=10,
                keep=max(2, args.restarts // 4), select_margin=0.5 * EPS)
        solve, cf, sm = judge(spec, robot, ms.th, sdfb, res)
        fam_rows["best_static"] = dict(row_b, sigma=sigma_b)
        fam_rows[f"ms{args.restarts}"] = dict(rates(solve, cf, sm),
                                              sigma=sigma_b)
        print(f"[{family}] +ms{args.restarts} (sigma {sigma_b}): "
              f"solve={solve.mean():.3f} cf={cf.mean():.3f}", flush=True)
        results[family] = fam_rows
        del sdfb

    dump_yaml(os.path.join(args.out, "results.yaml"), results)
    text = table(results, args)
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(text)
    print(text)
    return results


if __name__ == "__main__":
    main()
