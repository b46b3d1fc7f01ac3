"""Batched planning by manual ``step`` calls with per-problem convergence
freezing: port of ``examples/diff_gpmp2_2d_batch_step_example.py``.
Converged problems get a zero update while the rest go on: the host-loop
form of what ``core.gn.plan`` does inside its loop.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_2d_batch_step_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.examples.diff_gpmp2_2d_batch_example import endpoints
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

B, T, STEPS, TOL_DELTA = 8, 40, 60, 1e-2


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    planner = DiffGPMP2Planner(gp, obs, dict(pp, total_time_step=T), opt,
                               _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    img, sdf, _ = _common.box_world(dev, dtype)
    sdf_b = sdf.expand(B, *sdf.shape)
    start_np, goal_np = endpoints(B, 3, 3.5, 4.5)
    start = torch.tensor(start_np, dtype=dtype, device=dev)
    goal = torch.tensor(goal_np, dtype=dtype, device=dev)
    th = th0 = straight_line_traj(start[:, :2], goal[:, :2], 10.0, T)
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    for it in range(STEPS):
        dth, err, _, _ = planner.step(th, start, goal, sdf_b)
        if it == 0:
            err_init = err
        # Freeze converged problems: their update is zeroed.
        dth = torch.where(conv[:, None, None], torch.zeros_like(dth), dth)
        th = th + dth
        conv = conv | (torch.linalg.vector_norm(dth.reshape(B, -1), dim=-1)
                       < TOL_DELTA)
        done = bool(conv.all())
        if it % 10 == 0 or done:
            print(f"iter {it:3d}: err mean {float(err.mean()):.4f}  "
                  f"converged {int(conv.sum())}/{B}")
        if done:
            break
    print("final per-problem error:", np.round(_common.np_(err), 4))
    if args.plot:
        _common.plot_plan(img, th0[0], th[0],
                          "diff_gpmp2_2d_batch_step_example.png")
    return {"err_init": err_init, "err_final": err, "steps": it + 1,
            "converged": int(conv.sum()), "th": th}


if __name__ == "__main__":
    main()
