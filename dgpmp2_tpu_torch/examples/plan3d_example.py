"""3-D point-robot planning in voxel worlds: port of
``examples/plan3d_example.py``.  Each world's SDF is built by the exact
EDT on the device, planned through ``core.multistart`` (8 restarts) and,
with ``--plot``, drawn as z-slices through ``Env3D``.

  1. A central box: the plan detours around it in 3-D.
  2. A wall open only near the ceiling: the only way through is over the
     top, a motion no planar planner makes.

The perturbations come from a ``torch.Generator`` seeded with 0.

    python -m dgpmp2_tpu_torch.examples.plan3d_example [--device cpu]
        [--dtype float64] [--plot]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph, multistart
from dgpmp2_tpu_torch.envs import Env3D
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.robots import PointRobot3D

LIMS = dict(x_lims=(-5.0, 5.0), y_lims=(-5.0, 5.0), z_lims=(-5.0, 5.0))
N, T, RESTARTS = 48, 30, 8
CFG = gn.OptimConfig(reg=0.1, max_iters=40)
ROBOT = PointRobot3D(sphere_radii=(0.3,))
SPEC = graph.GraphSpec(dof=3, state_dim=6, total_time_step=T, **LIMS)


def worlds():
    """(name, voxels, start, goal, seed bump in z) of the two worlds."""
    box = np.ones((N, N, N), np.float32)
    box[18:30, 18:30, 18:30] = 0.0
    wall = np.ones((N, N, N), np.float32)
    wall[0:35, 18:29, :] = 0.0  # z voxels 0..34 blocked; open above ~+2.3
    return (("box", box, [-4.0, -4.0, -4.0], [4.0, 4.0, 4.0], 0.0),
            ("wall", wall, [0.0, -4.0, 0.0], [0.0, 4.0, 0.0], 1.5))


def problem(start_p, goal_p, bump, dev, dtype):
    """(params, th0) of a world: the straight seed, bumped in z by
    ``bump``·sin(πs)."""
    start = torch.tensor([start_p + [0.0] * 3], dtype=dtype, device=dev)
    goal = torch.tensor([goal_p + [0.0] * 3], dtype=dtype, device=dev)
    params = graph.default_params(SPEC, ROBOT, start, goal, qc_inv=np.eye(3),
                                  cost_sigma=0.05, epsilon_dist=0.4,
                                  k_s=0.01, k_g=0.01, dtype=dtype)
    s = torch.linspace(0.0, 1.0, T + 1, dtype=dtype, device=dev)[None, :,
                                                                 None]
    pos = (1 - s) * start[:, None, :3] + s * goal[:, None, :3]
    pos[..., 2] += bump * torch.sin(math.pi * s[..., 0])
    return params, torch.cat([pos, torch.zeros_like(pos)], dim=-1)


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    out = {}
    for i, (name, vox, start_p, goal_p, bump) in enumerate(worlds()):
        print(f"[{i + 1}] {name}:")
        env = Env3D(LIMS, device=dev, dtype=dtype)
        env.initialize_from_voxels(vox)
        params, th0 = problem(start_p, goal_p, bump, dev, dtype)
        sdf = env.sedt[None]
        gen = torch.Generator(device=dev).manual_seed(0)
        r = multistart.plan_multistart(SPEC, ROBOT, params, th0, sdf, CFG,
                                       gen, restarts=RESTARTS, amp=1.5)
        d, _ = env.get_signed_obstacle_distance(r.th[0, :, :3])
        res = {"err_init": graph.graph_error(SPEC, ROBOT, params, th0, sdf),
               "err_final": graph.graph_error(SPEC, ROBOT, params, r.th, sdf),
               "contact_free": bool(r.contact_free[0]),
               "clearance": float(d.min()), "iters": int(r.iters[0]),
               "peak_z": float(r.th[0, :, 2].max()), "th": r.th}
        print(f"  contact_free={res['contact_free']}  "
              f"min clearance={res['clearance']:.3f} m  "
              f"iters={res['iters']}")
        if name == "wall":
            print(f"  peak altitude {res['peak_z']:.2f} m (wall top ≈ +2.3 m)")
        out[name] = res
        if args.plot:
            render(env, _common.np_(r.th[0]), _common.np_(th0[0]),
                   (-2.0, 0.0) if name == "box" else (0.0, 3.0),
                   f"plan3d_{name}.png")
    return out


def render(env, th, th0, zs, name):
    plt, fig, axes = _common.figure(1, len(zs), figsize=(5 * len(zs), 5))
    for ax, z in zip(axes, zs):
        sl = env.slice_env2d(z)
        ax.imshow(sl.image, cmap="gray", extent=(*env.x_lims, *env.y_lims),
                  origin="upper")
        ax.plot(th0[:, 0], th0[:, 1], "r--", lw=1, label="seed (xy)")
        ax.plot(th[:, 0], th[:, 1], "b-", lw=2, label="plan (xy)")
        near = np.abs(th[:, 2] - z) < 0.75
        ax.plot(th[near, 0], th[near, 1], "co", ms=5,
                label=f"states near z={z:g}")
        ax.set_title(f"z = {z:g} m slice")
        ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    _common.save(plt, fig, name)


if __name__ == "__main__":
    main()
