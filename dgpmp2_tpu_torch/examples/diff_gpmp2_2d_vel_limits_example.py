"""Velocity-limited planning: port of
``examples/diff_gpmp2_2d_vel_limits_example.py`` (the reference ships that
example empty): plan with per-axis velocity hinge factors and report the
share of velocity components over the limit before and after.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_2d_vel_limits_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

V_LIM = 1.2
START, GOAL = (-4.0, -4.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0)


def violation(th) -> float:
    """The share of velocity components above the limit."""
    v = th[0, :, 2:].abs()
    return float((v > V_LIM + 1e-3).double().mean())


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    pp = dict(pp, use_vel_limits=True)
    gp = dict(gp, v_x=V_LIM, v_y=V_LIM)
    img, sdf, _ = _common.box_world(dev, dtype)
    start = torch.tensor([START], dtype=dtype, device=dev)
    goal = torch.tensor([GOAL], dtype=dtype, device=dev)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    th_init = straight_line_traj(start[:, :2], goal[:, :2],
                                 pp["total_time_sec"], pp["total_time_step"])
    result = planner.plan(th_init, start, goal, sdf[None])
    viol0, viol1 = violation(th_init), violation(result.th)
    vmax = float(result.th[..., 2:].abs().max())
    print(f"err {float(result.err_init[0]):.3f} -> "
          f"{float(result.err_final[0]):.5f}")
    print(f"velocity-limit violation rate: init={viol0:.2%} "
          f"final={viol1:.2%}")
    print(f"max |v| final: {vmax:.3f} (limit {V_LIM})")
    if args.plot:
        _common.plot_plan(img, th_init[0], result.th[0],
                          "diff_gpmp2_2d_vel_limits_example.png")
    return {"err_init": result.err_init, "err_final": result.err_final,
            "iters": result.iters, "violation_init": viol0,
            "violation_final": viol1, "max_v": vmax, "th": result.th}


if __name__ == "__main__":
    main()
