"""A nonholonomic x-y-heading robot: port of
``examples/diff_gpmp2_nonholonomic_example.py``, the unicycle constraint
factor on the 6-D state.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_nonholonomic_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.core.factors import nonholonomic_residual
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import PointRobotXYH
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

START = (-4.0, -4.0, 0.785, 0.0, 0.0, 0.0)
GOAL = (4.0, 4.0, 0.785, 0.0, 0.0, 0.0)


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, _ = _common.load_configs("gpmp2_xyh_params.yaml")
    img, sdf, _ = _common.box_world(dev, dtype)
    start = torch.tensor([START], dtype=dtype, device=dev)
    goal = torch.tensor([GOAL], dtype=dtype, device=dev)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                               PointRobotXYH(sphere_radii=(0.4,)),
                               dtype=dtype, device=dev)
    th_init = straight_line_traj(start[:, :3], goal[:, :3],
                                 pp["total_time_sec"], pp["total_time_step"])
    result = planner.plan(th_init, start, goal, sdf[None])
    viol, _ = nonholonomic_residual(result.th)
    max_viol = float(viol.abs().max())
    print(f"err {float(result.err_init[0]):.3f} -> "
          f"{float(result.err_final[0]):.5f} in {int(result.iters[0])} iters")
    print(f"max |nonholonomic residual|: {max_viol:.5f}")
    if args.plot:
        _common.plot_plan(img, th_init[0], result.th[0],
                          "diff_gpmp2_nonholonomic_example.png")
    return {"err_init": result.err_init, "err_final": result.err_final,
            "iters": result.iters, "max_residual": max_viol, "th": result.th}


if __name__ == "__main__":
    main()
