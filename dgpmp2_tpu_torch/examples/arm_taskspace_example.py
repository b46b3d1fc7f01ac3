"""Task-space arm planning with the full constraint stack in one
Gauss-Newton problem: port of ``examples/arm_taskspace_example.py``.

  * a workspace end-effector goal (a target point, no IK);
  * obstacle avoidance through the FK sphere model;
  * joint position limits;
  * self-collision hinges.

The example holds the plan to its own claims: the tip within 0.1 m of the
target and every sphere clear of the obstacle, or it raises.  It plans
with plain Gauss-Newton, as the JAX example does; ``--method lm`` plans
with Levenberg-Marquardt.  Plain GN on this arm is chaotic (steps of tens
of radians): on the CPU it meets the claims, in float32 on the H100 it has
missed them, where LM meets them.

    python -m dgpmp2_tpu_torch.examples.arm_taskspace_example
        [--device cpu] [--dtype float64] [--method lm] [--plot]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PlanarArmNLink, self_collision_pairs
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T, RES = 30, 10.0 / 96
ARM = PlanarArmNLink(link_lengths=(1.8, 1.4, 1.2), spheres_per_link=2,
                     sphere_radii=(0.25,))
CFG = gn.OptimConfig(reg=0.1, max_iters=80)
TARGET = (2.6, 2.6)  # behind the obstacle


def problem(dev, dtype):
    """(spec, arm, params, th0, sdf (1, H, W), image, pairs)."""
    pairs = self_collision_pairs(ARM, eps_self=0.05)
    d = ARM.state_dim
    spec = graph.GraphSpec(
        total_time_step=T, dof=ARM.dofs, state_dim=d, nlinks=ARM.nlinks,
        use_workspace_goal=True, use_joint_limits=True,
        use_self_collision=True, self_pairs=pairs)
    img = np.ones((96, 96))
    # An obstacle on the tip's sweep arc (x in [3.2, 4.4], y in [0.6,
    # 1.8]): the naive swing crosses it, avoiding it means tucking the arm.
    img[31:42, 79:90] = 0.0
    sdf = _common.occupancy_sdf(img, RES, dev, dtype)[None]
    start = torch.zeros((1, d), dtype=dtype, device=dev)
    start[0, 0] = -0.4
    goal = start  # the joint goal is unused (a weak prior): only the tip
    target = torch.tensor([TARGET], dtype=dtype, device=dev)
    params = graph.default_params(
        spec, ARM, start, goal, qc_inv=np.eye(ARM.dofs), cost_sigma=0.05,
        epsilon_dist=0.25, k_s=0.001, k_g=100.0,  # joint-space goal ~off
        k_wg=0.01, workspace_goal=target,
        k_jl=0.01, q_min=(-2.4,) * ARM.dofs, q_max=(2.4,) * ARM.dofs,
        k_self=0.02, eps_self=0.05, dtype=dtype)
    th0 = straight_line_traj(start[:, :ARM.dofs], goal[:, :ARM.dofs], 10.0,
                             T)
    return spec, ARM, params, th0, sdf, img, pairs


@torch.no_grad()
def solve(dev, dtype, method="gauss_newton"):
    """The plan and its measures: tip error, obstacle clearance (less the
    0.25 m radius), the least self pair gap, the largest joint angle;
    the plotting inputs under ``"plot"``."""
    spec, arm, params, th0, sdf, img, pairs = problem(dev, dtype)
    r = gn.plan(spec, arm, params, th0, sdf,
                dataclasses.replace(CFG, method=method))
    centers, _ = arm.fk(r.th)
    tip_err = float(torch.linalg.vector_norm(
        centers[0, -1, -1] - params.p_goal[0]))
    d_obs, _ = sdf_ops.lookup(sdf, centers[0].reshape(1, -1, 2), RES,
                              (-5, 5), (-5, 5))
    pi = torch.as_tensor(np.asarray(pairs), device=r.th.device)
    dist_self = torch.linalg.vector_norm(
        centers[..., pi[:, 0], :] - centers[..., pi[:, 1], :], dim=-1)
    return {"err_init": r.err_init, "err_final": r.err_final,
            "iters": r.iters, "tip_err": tip_err,
            "clearance": float(d_obs.min()) - 0.25,
            "self_gap": float(dist_self.min()) - 0.5,
            "max_q": float(r.th[0, :, :arm.dofs].abs().max()), "th": r.th,
            "plot": (img, centers)}


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--method", choices=("gauss_newton", "lm"),
                   default="gauss_newton")
    args = _common.parse(p, argv)
    out = solve(args.device, args.dtype, args.method)
    tip_err = out["tip_err"]
    print(f"{args.method}: tip -> target error {tip_err:.3f} m; min "
          f"obstacle clearance {out['clearance']:+.3f} m; min self pair gap "
          f"{out['self_gap']:+.3f} m; max |q| {out['max_q']:.2f} "
          f"(limit 2.4)")
    img, centers = out.pop("plot")
    if args.plot:
        plot(img, out["th"], centers, tip_err)
    if not (tip_err < 0.1 and out["clearance"] > 0.0):
        raise RuntimeError(
            f"the plan misses its claims: tip error {tip_err:.4f} m (< 0.1 "
            f"wanted), obstacle distance {out['clearance'] + 0.25:.4f} m "
            "(> 0.25 wanted)")
    return out


def plot(img, th, centers, tip_err):
    plt, fig, ax = _common.figure(figsize=(6.5, 6.5))
    ax.imshow(img, cmap="gray", extent=(-5, 5, -5, 5), origin="upper")
    q = _common.np_(th[0, :, :ARM.dofs])
    for k in range(0, T + 1, 3):
        ang = np.cumsum(q[k])
        xs, ys = [0.0], [0.0]
        for a, lk in zip(ang, ARM.link_lengths):
            xs.append(xs[-1] + lk * np.cos(a))
            ys.append(ys[-1] + lk * np.sin(a))
        ax.plot(xs, ys, "-o", alpha=0.2 + 0.8 * k / T, color="tab:blue",
                markersize=3)
    ax.plot(*TARGET, "r*", markersize=16, label="workspace target")
    tips = _common.np_(centers[0, :, -1])
    ax.plot(tips[:, 0], tips[:, 1], "r-", lw=1, label="tip path")
    ax.legend()
    ax.set_title("task-space goal + obstacles + joint limits + "
                 f"self-collision\ntip error {tip_err:.3f} m, no IK supplied")
    _common.save(plt, fig, "arm_taskspace_example.png")


if __name__ == "__main__":
    main()
