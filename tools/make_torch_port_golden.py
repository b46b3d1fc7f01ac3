#!/usr/bin/env python
"""Write tests/goldens/torch_port_plan_small.npz from the JAX package.

The golden ties the PyTorch port to the JAX reference on machines that have
no JAX (the GPU host): ``chip_smoke.py`` and ``tests/test_torch_golden.py``
rebuild the problem from the stored inputs and compare their plan with it.

Inputs: the bench.py problem construction at B=8 (occupancy images as uint8,
start and goal) and its config scalars.  Outputs: ``th``, ``err_init``,
``err_per_iter`` and ``err_ext_per_iter`` after ITERS fixed-damping GN
iterations of ``dgpmp2_tpu.core.gn.plan`` (standard engine), float64 on CPU.

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
from dgpmp2_tpu.robots import PointRobot2D  # noqa: E402
from dgpmp2_tpu.utils.trajectory import straight_line_traj  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "tests" / "goldens" / "torch_port_plan_small.npz"
B, T, IMSIZE, ITERS = 8, 100, 128, 5
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


def main():
    imgs, start, goal = bench_inputs(B)
    spec = graph.GraphSpec(total_time_step=T,
                           total_time_sec=CONFIG["total_time_sec"])
    robot = PointRobot2D()
    sdf = sdf_ops.sdf_from_occupancy(jnp.asarray(imgs, jnp.float64),
                                     res=10.0 / IMSIZE)
    params = graph.default_params(
        spec, robot, jnp.asarray(start), jnp.asarray(goal), qc_inv=np.eye(2),
        cost_sigma=CONFIG["cost_sigma"], epsilon_dist=CONFIG["epsilon_dist"],
        k_s=CONFIG["k_s"], k_g=CONFIG["k_g"], dtype=jnp.float64,
    )
    th0 = straight_line_traj(jnp.asarray(start[:, :2]),
                             jnp.asarray(goal[:, :2]),
                             spec.total_time_sec, T)
    cfg = gn.OptimConfig(reg=CONFIG["reg"], max_iters=ITERS, tol_delta=0.0,
                         engine="standard")
    out = gn.plan(spec, robot, params, th0, sdf, cfg)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT, images=imgs, start=start, goal=goal, T=T, imsize=IMSIZE,
        iters=ITERS, **{k: np.float64(v) for k, v in CONFIG.items()},
        th=np.asarray(out.th), err_init=np.asarray(out.err_init),
        err_per_iter=np.asarray(out.err_per_iter),
        err_ext_per_iter=np.asarray(out.err_ext_per_iter),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
