"""A host loop of differentiable GN steps: port of
``examples/diff_gpmp2_2d_step_example.py``, one ``DiffGPMP2Planner.step``
per iteration and an explicit convergence test on the step's norm.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_2d_step_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

START, GOAL = (-4.0, -4.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0)


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    start = torch.tensor([START], dtype=dtype, device=dev)
    goal = torch.tensor([GOAL], dtype=dtype, device=dev)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    th = th_init = straight_line_traj(start[:, :2], goal[:, :2],
                                      pp["total_time_sec"],
                                      pp["total_time_step"])
    sdfb = sdf[None]
    errs = []
    for j in range(opt["max_iters"]):
        dth, err, _, _ = planner.step(th, start, goal, sdfb)
        th = th + dth
        errs.append(float(err[0]))
        nd = float(torch.linalg.vector_norm(dth))
        if j % 10 == 0:
            print(f"iter {j:3d}: err={errs[-1]:.5f} |dtheta|={nd:.6f}")
        if nd < opt["tol_delta"]:
            print(f"converged at iter {j}")
            break
    if args.plot:
        _common.plot_plan(img, th_init[0], th[0],
                          "diff_gpmp2_2d_step_example.png")
    # err is each step's error before its update: the last is the error
    # of the iterate the final step started from.
    return {"err_init": errs[0], "err_final": errs[-1], "steps": j + 1,
            "th": th}


if __name__ == "__main__":
    main()
