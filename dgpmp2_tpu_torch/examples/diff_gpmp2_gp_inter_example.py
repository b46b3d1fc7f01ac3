"""GP-interpolated dense collision checking: port of
``examples/diff_gpmp2_gp_inter_example.py``.  A thin wall slips between
the support states of a T=8 plan without interpolation; with it, the
interpolated obstacle factors push the path through the wall's gap.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_gp_inter_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T, CHECKS, IMSIZE, FINE = 8, 48, 96, 300
LIMS = (-5.0, 5.0)


def wall_world():
    """A thin wall at columns 46-49 with a gap at rows 44-51."""
    img = np.ones((IMSIZE, IMSIZE))
    img[:, 46:50] = 0.0
    img[44:52, 46:50] = 1.0
    return img, 10.0 / IMSIZE


def fine_clearance(th, sdf, res) -> float:
    """The least SDF value along the piecewise-linear path at 300 points
    (one lookup)."""
    t = np.linspace(0, 1, FINE)
    seg = np.clip((t * T).astype(int), 0, T - 1)
    frac = torch.tensor((t * T - seg)[:, None], dtype=th.dtype,
                        device=th.device)
    idx = torch.as_tensor(seg, device=th.device)
    pos = th[0, :, :2]
    pts = pos[idx] * (1 - frac) + pos[idx + 1] * frac
    d, _ = sdf_ops.lookup(sdf[None], pts[None].contiguous(), res, LIMS, LIMS)
    return float(d.min())


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    pp = dict(pp, total_time_step=T, total_check_step=CHECKS)
    robot = make_robot(dict(robot_data, sphere_radius=[0.2]))
    img, res = wall_world()
    sdf = _common.occupancy_sdf(img, res, dev, dtype)
    start = torch.tensor([[-4.0, 0.3, 0.0, 0.0]], dtype=dtype, device=dev)
    goal = torch.tensor([[4.0, 0.3, 0.0, 0.0]], dtype=dtype, device=dev)
    th0 = straight_line_traj(start[:, :2], goal[:, :2],
                             pp["total_time_sec"], T)
    out = {}
    for use_inter in (False, True):
        planner = DiffGPMP2Planner(
            gp, dict(obs, epsilon_dist=0.3), dict(pp, use_gp_inter=use_inter),
            opt, _common.env_params(env), robot, dtype=dtype, device=dev)
        r = planner.plan(th0, start, goal, sdf[None])
        clearance = fine_clearance(r.th, sdf, res)
        print(f"use_gp_inter={use_inter}: err {float(r.err_init[0]):.3f} -> "
              f"{float(r.err_final[0]):.5f}; fine-grained min clearance = "
              f"{clearance:.3f} m (robot radius 0.2)")
        out[f"gp_inter_{use_inter}"] = {
            "err_init": r.err_init, "err_final": r.err_final,
            "iters": r.iters, "clearance": clearance, "th": r.th}
    if args.plot:
        _common.plot_plan(img, th0[0], r.th[0],
                          "diff_gpmp2_gp_inter_example.png")
    return out


if __name__ == "__main__":
    main()
