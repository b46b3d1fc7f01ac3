"""The self-collision factor on a 3-link arm: port of
``examples/self_collision_example.py``.  The commanded goal folds the arm
through its own body; without the factor the plan drives into the fold,
with it the arm stops at the safety margin.

    python -m dgpmp2_tpu_torch.examples.self_collision_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.robots import PlanarArmNLink, self_collision_pairs
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T = 20
ARM = PlanarArmNLink(link_lengths=(1.8, 1.4, 1.2), spheres_per_link=2,
                     sphere_radii=(0.25,))
CFG = gn.OptimConfig(reg=0.1, max_iters=60)


def problems(dev, dtype):
    """{"off": ..., "on": ...} of (spec, params), and th0 and the
    obstacle-free SDF (1, 64, 64) they share, and the pairs."""
    pairs = self_collision_pairs(ARM, eps_self=0.1)
    d = ARM.state_dim
    base = dict(total_time_step=T, dof=ARM.dofs, state_dim=d,
                nlinks=ARM.nlinks)
    spec_on = graph.GraphSpec(use_self_collision=True, self_pairs=pairs,
                              **base)
    spec_off = graph.GraphSpec(**base)
    sdf = torch.full((1, 64, 64), 10.0, dtype=dtype, device=dev)
    start = torch.zeros((1, d), dtype=dtype, device=dev)
    goal = torch.zeros((1, d), dtype=dtype, device=dev)
    goal[0, 1] = 2.7  # fold link 2 back
    kw = dict(qc_inv=np.eye(ARM.dofs), cost_sigma=0.5, epsilon_dist=0.2,
              k_s=0.001, k_g=0.05, dtype=dtype)
    p_on = graph.default_params(spec_on, ARM, start, goal, k_self=0.01,
                                eps_self=0.05, **kw)
    p_off = graph.default_params(spec_off, ARM, start, goal, **kw)
    th0 = straight_line_traj(start[:, :ARM.dofs], goal[:, :ARM.dofs], 10.0,
                             T)
    return {"off": (spec_off, p_off), "on": (spec_on, p_on)}, th0, sdf, pairs


def worst_penetration(th, pairs) -> float:
    """The largest overlap of two spheres of a pair (0.5 m apart is
    contact)."""
    c, _ = ARM.fk(th)
    pi = torch.as_tensor(np.asarray(pairs), device=th.device)
    dist = torch.linalg.vector_norm(c[..., pi[:, 0], :] - c[..., pi[:, 1], :],
                                    dim=-1)
    return float((0.5 - dist).max())


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    specs, th0, sdf, pairs = problems(args.device, args.dtype)
    out = {}
    for name, (spec, params) in specs.items():
        r = gn.plan(spec, ARM, params, th0, sdf, CFG)
        out[f"factor_{name}"] = {
            "err_init": r.err_init, "err_final": r.err_final,
            "iters": r.iters, "worst_penetration":
            worst_penetration(r.th, pairs), "th": r.th}
    print(f"commanded goal fold: factor OFF worst pair penetration "
          f"{out['factor_off']['worst_penetration']:+.3f} m (tangled), "
          f"factor ON {out['factor_on']['worst_penetration']:+.3f} m "
          f"(clear, stops short of the command)")
    if args.plot:
        plot(out)
    return out


def plot(out):
    plt, fig, axes = _common.figure(1, 2, figsize=(11, 5.5), sharex=True,
                                    sharey=True)
    for ax, key, title in ((axes[0], "factor_off", "no self-collision factor"),
                           (axes[1], "factor_on", "with self-collision factor")):
        th = out[key]["th"]
        q = _common.np_(th[0, :, :ARM.dofs])
        for k in range(0, T + 1, 4):
            ang = np.cumsum(q[k])
            xs, ys = [0.0], [0.0]
            for a, lk in zip(ang, ARM.link_lengths):
                xs.append(xs[-1] + lk * np.cos(a))
                ys.append(ys[-1] + lk * np.sin(a))
            ax.plot(xs, ys, "-o", alpha=0.25 + 0.75 * k / T,
                    color="tab:blue", markersize=3)
        c, _ = ARM.fk(th)
        for (x, y), rad in zip(_common.np_(c[0, -1]), ARM.sphere_radii):
            ax.add_patch(plt.Circle((x, y), rad, fill=False,
                                    color="tab:red", lw=0.8))
        ax.set_title(f"{title}\nworst pair penetration "
                     f"{out[key]['worst_penetration']:+.3f} m")
        ax.set_aspect("equal")
        ax.set_xlim(-1, 4)
        ax.set_ylim(-1.5, 2.5)
    _common.save(plt, fig, "self_collision_example.png")


if __name__ == "__main__":
    main()
