"""Classic (non-differentiable) GPMP2 with GN and LM on a box world: port
of ``examples/gpmp2_2d_example.py``.

    python -m dgpmp2_tpu_torch.examples.gpmp2_2d_example [--device cpu]
        [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import GPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

OPTIM = {"plan_time": 60.0, "max_iters": 40, "tol_err": 1e-3,
         "tol_delta": 1e-4, "reg": 0.1}
START, GOAL = (-4.0, -4.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0)


def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, _, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    start = torch.tensor(START, dtype=dtype, device=dev)
    goal = torch.tensor(GOAL, dtype=dtype, device=dev)
    planner = GPMP2Planner(gp, obs, pp, _common.env_params(env),
                           make_robot(robot_data), dtype=dtype, device=dev)
    th_init = straight_line_traj(start[None, :2], goal[None, :2],
                                 pp["total_time_sec"],
                                 pp["total_time_step"])[0]
    out = {}
    for method in ("gauss_newton", "lm"):
        th, e0, ef, _, iters, tt = planner.plan(
            start, goal, th_init, sdf, dict(OPTIM, method=method))
        print(f"{method:13s}: err {e0:.4f} -> {ef:.6f} in {iters} iters "
              f"({tt:.2f}s)")
        out[method] = {"err_init": e0, "err_final": ef, "iters": iters,
                       "seconds": tt, "th": th}
    if args.plot:
        _common.plot_plan(img, th_init, th, "gpmp2_2d_example.png")
    return out


if __name__ == "__main__":
    main()
