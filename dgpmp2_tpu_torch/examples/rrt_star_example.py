"""RRT* seeding and GPMP2 smoothing: port of
``examples/rrt_star_example.py``.  The port's native RRT* (``g++``-built
from ``dgpmp2_tpu_torch/csrc/dgpmp2_native.cpp``) finds a feasible path,
GPMP2 smooths it into a dynamically consistent trajectory.  Without a
native toolchain the example raises: it has no plan without its seed.

    python -m dgpmp2_tpu_torch.examples.rrt_star_example [--device cpu]
        [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import path_to_traj_avg_vel

START, GOAL = (-4.0, -4.0), (4.0, 4.0)


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    path = native.rrt_star(_common.np_(sdf), START, GOAL, env["x_lims"],
                           env["y_lims"], clearance=0.45, plan_time=3.0,
                           seed=0)
    if path is None:
        raise RuntimeError("RRT* found no path")
    interp = native.interpolate_path(path, pp["total_time_step"] + 1)
    th_init = path_to_traj_avg_vel(
        torch.tensor(interp, dtype=dtype, device=dev),
        pp["total_time_sec"])[None]
    start = torch.tensor([[*START, 0.0, 0.0]], dtype=dtype, device=dev)
    goal = torch.tensor([[*GOAL, 0.0, 0.0]], dtype=dtype, device=dev)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    result = planner.plan(th_init, start, goal, sdf[None])
    print(f"RRT* waypoints: {len(path)}; GPMP2 smoothing err "
          f"{float(result.err_init[0]):.3f} -> "
          f"{float(result.err_final[0]):.5f}")
    if args.plot:
        _common.plot_plan(img, th_init[0], result.th[0],
                          "rrt_star_example.png")
    return {"waypoints": len(path), "err_init": result.err_init,
            "err_final": result.err_final, "iters": result.iters,
            "th": result.th}


if __name__ == "__main__":
    main()
