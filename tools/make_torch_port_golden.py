#!/usr/bin/env python
"""Write the float64 goldens of the PyTorch port from the JAX package.

The goldens tie the PyTorch port to the JAX reference on machines that have
no JAX (the GPU host): ``chip_smoke.py`` and ``tests/test_torch_port.py``
rebuild each problem from the stored inputs and compare their plan with it.

* ``tests/goldens/torch_port_plan_small.npz``: the bench.py problem
  construction at B=8 (128x128 occupancy images as uint8, start and goal).
* ``tests/goldens/torch_port_plan3d_small.npz``: the 3-D path at B=4,
  PointRobot3D in 16^3 voxel worlds with one carved 4^3 box each (uint8
  occupancy), starts near (-4,-4,-4) and goals near (4,4,4).

Each stores its config scalars and, after ITERS fixed-damping GN iterations
of ``dgpmp2_tpu.core.gn.plan`` (standard engine, gather lookups), ``th``,
``err_init``, ``err_per_iter`` and ``err_ext_per_iter``, float64 on CPU.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dgpmp2_tpu.core import gn, graph  # noqa: E402
from dgpmp2_tpu.ops import sdf as sdf_ops  # noqa: E402
from dgpmp2_tpu.robots import PointRobot2D, PointRobot3D  # noqa: E402
from dgpmp2_tpu.utils.trajectory import straight_line_traj  # noqa: E402

GOLDENS = Path(__file__).resolve().parents[1] / "tests" / "goldens"
OUT = GOLDENS / "torch_port_plan_small.npz"
OUT3D = GOLDENS / "torch_port_plan3d_small.npz"
B, T, IMSIZE, ITERS = 8, 100, 128, 5
B3D, VOX, BOX = 4, 16, 4
CONFIG = dict(total_time_sec=10.0, reg=0.1, cost_sigma=0.05, epsilon_dist=0.4,
              k_s=0.01, k_g=0.01, x_lo=-5.0, x_hi=5.0)


def bench_inputs(b: int, seed: int = 0):
    """bench.py:44-68's construction: one 20x20 obstacle per image."""
    rng = np.random.default_rng(seed)
    imgs = np.ones((b, IMSIZE, IMSIZE), np.uint8)
    for i in range(b):
        r, c = rng.integers(20, 90, 2)
        imgs[i, r:r + 20, c:c + 20] = 0
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    return imgs, start, goal


def box_worlds_3d(b: int, seed: int = 0):
    """(b, VOX, VOX, VOX) uint8 occupancy (1 free) with one BOX^3 box each,
    its low corner in [5, 8) on every axis, so that the straight line from
    the start to the goal runs through it; starts near (-4,-4,-4) and goals
    near (4,4,4) as (b, 6) states."""
    rng = np.random.default_rng(seed)
    vox = np.ones((b, VOX, VOX, VOX), np.uint8)
    for i, (z, r, c) in enumerate(rng.integers(5, 8, (b, 3))):
        vox[i, z:z + BOX, r:r + BOX, c:c + BOX] = 0
    start = np.zeros((b, 6))
    start[:, :3] = rng.uniform(-4.5, -3.5, (b, 3))
    goal = np.zeros((b, 6))
    goal[:, :3] = rng.uniform(3.5, 4.5, (b, 3))
    return vox, start, goal


def golden(out_path, spec, robot, occupancy, start, goal, sdf, qc_inv):
    """Plan ITERS GN iterations in float64 and save inputs and outputs."""
    params = graph.default_params(
        spec, robot, jnp.asarray(start), jnp.asarray(goal), qc_inv=qc_inv,
        cost_sigma=CONFIG["cost_sigma"], epsilon_dist=CONFIG["epsilon_dist"],
        k_s=CONFIG["k_s"], k_g=CONFIG["k_g"], dtype=jnp.float64,
    )
    dof = spec.dof
    th0 = straight_line_traj(jnp.asarray(start[:, :dof]),
                             jnp.asarray(goal[:, :dof]),
                             spec.total_time_sec, T)
    cfg = gn.OptimConfig(reg=CONFIG["reg"], max_iters=ITERS, tol_delta=0.0,
                         engine="standard")
    out = gn.plan(spec, robot, params, th0, sdf, cfg)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_path, images=occupancy, start=start, goal=goal, T=T,
        imsize=occupancy.shape[-1], iters=ITERS,
        **{k: np.float64(v) for k, v in CONFIG.items()},
        th=np.asarray(out.th), err_init=np.asarray(out.err_init),
        err_per_iter=np.asarray(out.err_per_iter),
        err_ext_per_iter=np.asarray(out.err_ext_per_iter),
    )
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


def main():
    imgs, start, goal = bench_inputs(B)
    spec = graph.GraphSpec(total_time_step=T,
                           total_time_sec=CONFIG["total_time_sec"])
    sdf = sdf_ops.sdf_from_occupancy(jnp.asarray(imgs, jnp.float64),
                                     res=10.0 / IMSIZE)
    golden(OUT, spec, PointRobot2D(), imgs, start, goal, sdf, np.eye(2))

    vox, start, goal = box_worlds_3d(B3D)
    lims = (CONFIG["x_lo"], CONFIG["x_hi"])
    spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=T,
                           total_time_sec=CONFIG["total_time_sec"],
                           x_lims=lims, y_lims=lims, z_lims=lims)
    sdf_ops.set_lookup3d_method("gather")
    sdf = sdf_ops.sdf_from_occupancy_3d(jnp.asarray(vox, jnp.float64),
                                        res=10.0 / VOX)
    golden(OUT3D, spec, PointRobot3D(), vox, start, goal, sdf, np.eye(3))


if __name__ == "__main__":
    main()
