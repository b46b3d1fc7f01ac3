"""Classic GPMP2 one explicit step at a time: port of
``examples/gpmp2_2d_step_example.py``, a user-owned loop over
``GPMP2Planner.step`` with a convergence check after every step (and, with
``--plot``, each iterate drawn over the world).

    python -m dgpmp2_tpu_torch.examples.gpmp2_2d_step_example
        [--device cpu] [--dtype float64] [--plot]
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import GPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

START, GOAL = (-4.0, -4.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0)


def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    start = torch.tensor(START, dtype=dtype, device=dev)
    goal = torch.tensor(GOAL, dtype=dtype, device=dev)
    planner = GPMP2Planner(gp, obs, pp, _common.env_params(env),
                           make_robot(robot_data), dtype=dtype, device=dev)
    th = straight_line_traj(start[None, :2], goal[None, :2],
                            pp["total_time_sec"], pp["total_time_step"])[0]
    iterates = [th]
    tol_err = float(opt.get("tol_err", 1e-3))
    tol_delta = float(opt.get("tol_delta", 1e-4))
    max_iters = int(opt.get("max_iters", 40))
    err_init = planner.error(th, start, goal, sdf)
    j = 0
    while True:
        print(f"Current iteration, {j}")
        dtheta, err_old = planner.step(th, start, goal, sdf,
                                       {"reg": opt.get("reg", 0.0)})
        th = th + dtheta
        err_new = planner.error(th, start, goal, sdf)
        iterates.append(th)
        j += 1
        dth_norm = float(torch.linalg.vector_norm(dtheta))
        if (dth_norm < tol_delta or abs(err_new - err_old) < tol_err
                or j >= max_iters):
            print("Converged" if j < max_iters else "Max iterations")
            break
    print(f"final error {err_new:.6f} after {j} steps")
    if args.plot:
        plot_iterates(img, iterates, env)
    return {"err_init": err_init, "err_final": err_new, "steps": j, "th": th}


def plot_iterates(img, iterates, env):
    plt, fig, ax = _common.figure(figsize=(6, 6))
    ax.imshow(img, cmap="gray", extent=(*env["x_lims"], *env["y_lims"]),
              origin="upper")
    for j, th in enumerate(_common.np_(t) for t in iterates):
        if j == 0:
            ax.plot(th[:, 0], th[:, 1], "r--", label="initial")
        else:
            ax.plot(th[:, 0], th[:, 1], "-", color="gray",
                    linewidth=0.2 + 0.1 * j, alpha=min(1.0, 0.05 + 0.1 * j))
    ax.plot(th[:, 0], th[:, 1], "b-", linewidth=2, label="final")
    ax.legend()
    _common.save(plt, fig, "gpmp2_2d_step_example.png")


if __name__ == "__main__":
    main()
