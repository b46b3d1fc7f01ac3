"""Differentiable single-problem plan, then a gradient through the whole
unrolled plan: port of ``examples/diff_gpmp2_2d_example.py``.

The cotangent pulled back to ``th_init`` is a standard-normal draw of
numpy's generator seeded with 0 (the reference's ``th_final.backward``).

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_2d_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

START, GOAL = (-4.0, -4.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0)


def cotangent(shape) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(shape)


def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    start = torch.tensor([START], dtype=dtype, device=dev)
    goal = torch.tensor([GOAL], dtype=dtype, device=dev)
    th_init = straight_line_traj(start[:, :2], goal[:, :2],
                                 pp["total_time_sec"], pp["total_time_step"])
    sdfb = sdf[None]

    t0 = time.perf_counter()
    with torch.no_grad():
        result = planner.plan(th_init, start, goal, sdfb)
    _common.sync(dev)
    plan_s = time.perf_counter() - t0
    print(f"Initial cost = {float(result.err_init[0]):.4f}")
    print(f"Final cost   = {float(result.err_final[0]):.6f}")
    print(f"Iterations   = {int(result.iters[0])}")
    print(f"Plan time    = {plan_s:.2f}s")

    print("Differentiating through the whole plan ...")
    cot = torch.tensor(cotangent(tuple(result.th.shape)),
                       dtype=dtype, device=dev)
    t0 = time.perf_counter()
    th0 = th_init.clone().requires_grad_(True)
    scalar = torch.sum(planner.plan(th0, start, goal, sdfb).th * cot)
    (grad,) = torch.autograd.grad(scalar, th0)
    _common.sync(dev)
    grad_s = time.perf_counter() - t0
    grad_norm = float(torch.linalg.vector_norm(grad))
    print(f"Backprop time = {grad_s:.2f}s, |grad| = {grad_norm:.4f}")
    if args.plot:
        _common.plot_plan(img, th_init[0], result.th[0],
                          "diff_gpmp2_2d_example.png")
    return {"err_init": result.err_init, "err_final": result.err_final,
            "iters": result.iters, "plan_seconds": plan_s,
            "grad_seconds": grad_s, "grad_norm": grad_norm, "grad": grad,
            "th": result.th}


if __name__ == "__main__":
    main()
