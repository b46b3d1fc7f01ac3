"""Batched differentiable planning: port of
``examples/diff_gpmp2_2d_batch_example.py``, one plan over B problems with
per-problem convergence freezing.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_2d_batch_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

B = 8


def endpoints(b, seed, lo, hi):
    """(start, goal) (b, 4) numpy: positions drawn uniformly, the start in
    [-hi, -lo]², the goal in [lo, hi]², velocities zero."""
    rng = np.random.default_rng(seed)
    start, goal = np.zeros((b, 4)), np.zeros((b, 4))
    start[:, :2] = rng.uniform(-hi, -lo, (b, 2))
    goal[:, :2] = rng.uniform(lo, hi, (b, 2))
    return start, goal


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    start_np, goal_np = endpoints(B, 0, 3.0, 4.5)
    start = torch.tensor(start_np, dtype=dtype, device=dev)
    goal = torch.tensor(goal_np, dtype=dtype, device=dev)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    th_init = straight_line_traj(start[:, :2], goal[:, :2],
                                 pp["total_time_sec"], pp["total_time_step"])
    result = planner.plan(th_init, start, goal, sdf.expand(B, *sdf.shape))
    print("err_init :", np.round(_common.np_(result.err_init), 3))
    print("err_final:", np.round(_common.np_(result.err_final), 5))
    print("iters    :", _common.np_(result.iters))
    if args.plot:
        _common.plot_plan(img, th_init[0], result.th[0],
                          "diff_gpmp2_2d_batch_example.png")
    return {"err_init": result.err_init, "err_final": result.err_final,
            "iters": result.iters, "th": result.th}


if __name__ == "__main__":
    main()
