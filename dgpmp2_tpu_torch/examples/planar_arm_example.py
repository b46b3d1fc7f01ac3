"""A 2-link planar arm planned in joint space: port of
``examples/planar_arm_example.py``, the GP prior over joint angles and
collision spheres along both links whose FK Jacobians chain through the
obstacle factor.

    python -m dgpmp2_tpu_torch.examples.planar_arm_example [--device cpu]
        [--dtype float64] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.robots import PlanarArm2Link
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T = 40
ARM = PlanarArm2Link(link_lengths=(2.5, 2.0), spheres_per_link=3,
                     sphere_radii=(0.25,) * 6)
CFG = gn.OptimConfig(reg=0.1, max_iters=60)
COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.2, k_s=0.01,
           k_g=0.01)


def problem(dev, dtype):
    """(spec, arm, params, th0, sdf (1, H, W), image) of the example."""
    spec = graph.GraphSpec(total_time_step=T, nlinks=ARM.nlinks)
    img = np.ones((96, 96))
    img[20:38, 58:76] = 0.0  # an obstacle in the upper-right workspace
    sdf = _common.occupancy_sdf(img, 10.0 / 96, dev, dtype)[None]
    start = torch.tensor([[-0.6, 0.5, 0.0, 0.0]], dtype=dtype, device=dev)
    goal = torch.tensor([[1.7, 0.5, 0.0, 0.0]], dtype=dtype, device=dev)
    params = graph.default_params(spec, ARM, start, goal, **COV, dtype=dtype)
    th0 = straight_line_traj(start[:, :2], goal[:, :2], 10.0, T)
    return spec, ARM, params, th0, sdf, img


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    spec, arm, params, th0, sdf, img = problem(args.device, args.dtype)
    r = gn.plan(spec, arm, params, th0, sdf, CFG)
    print(f"arm plan: err {float(r.err_init[0]):.3f} -> "
          f"{float(r.err_final[0]):.5f} in {int(r.iters[0])} iters")
    if args.plot:
        plot(img, arm, r.th)
    return {"err_init": r.err_init, "err_final": r.err_final,
            "iters": r.iters, "th": r.th}


def plot(img, arm, th):
    plt, fig, ax = _common.figure(figsize=(6, 6))
    ax.imshow(img, cmap="gray", extent=(-5, 5, -5, 5), origin="upper")
    l1, l2 = arm.link_lengths
    q = _common.np_(th[0])
    for k in range(0, T + 1, 5):
        q1, q2 = q[k, :2]
        ex, ey = l1 * np.cos(q1), l1 * np.sin(q1)
        tx, ty = ex + l2 * np.cos(q1 + q2), ey + l2 * np.sin(q1 + q2)
        ax.plot([0, ex, tx], [0, ey, ty], "-o", alpha=0.3 + 0.7 * k / T,
                color="tab:blue", markersize=3)
    centers, _ = arm.fk(th)
    tips = _common.np_(centers[0, :, -1])
    ax.plot(tips[:, 0], tips[:, 1], "r-", lw=1, label="tip path")
    ax.legend()
    _common.save(plt, fig, "planar_arm_example.png")


if __name__ == "__main__":
    main()
