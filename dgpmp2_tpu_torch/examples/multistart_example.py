"""Batched multi-start planning on forest-like clutter: port of
``examples/multistart_example.py``.

On dense clutter the straight seed's Gauss-Newton basin often ends in
contact.  ``GPMP2Planner.plan_multistart`` plans K endpoint-preserving
perturbations of every problem as one (K·B) batch and keeps the best per
problem; staged pruning explores all K for a few iterations and finishes
only the best few.  The perturbations come from a ``torch.Generator``
seeded with 0, so the contact-free counts need not equal the JAX
example's.

    python -m dgpmp2_tpu_torch.examples.multistart_example [--device cpu]
        [--dtype float64] [--max_iters 40] [--plot]
"""
from __future__ import annotations

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner, GPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

B, T, IMSIZE, K, ITERS = 8, 30, 128, 16, 40
RUNS = {"restart 0 only": dict(restarts=1),
        "16 restarts": dict(restarts=K, amp=1.5),
        "staged, keep 4": dict(restarts=K, amp=1.5, prune_iters=8, keep=4)}


def clutter():
    """Forty scattered squares (numpy seed 5) and the B (start, goal)
    pairs drawn after them from the same generator."""
    rng = np.random.default_rng(5)
    img = np.ones((IMSIZE, IMSIZE))
    for _ in range(40):
        cy, cx = rng.integers(14, IMSIZE - 20, 2)
        s = rng.integers(5, 10)
        img[cy:cy + s, cx:cx + s] = 0.0
    start, goal = np.zeros((B, 4)), np.zeros((B, 4))
    start[:, :2] = rng.uniform(-4.6, -3.8, (B, 2))
    goal[:, :2] = rng.uniform(3.8, 4.6, (B, 2))
    return img, start, goal


@torch.no_grad()
def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--max_iters", type=int, default=ITERS,
                   help="GN iterations (more than the staged runs' 8)")
    args = _common.parse(p, argv)
    optim = {"method": "gauss_newton", "max_iters": args.max_iters,
             "reg": 0.1}
    dev, dtype = args.device, args.dtype
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    pp = dict(pp, total_time_step=T)
    img, start_np, goal_np = clutter()
    sdf = _common.occupancy_sdf(img, 10.0 / IMSIZE, dev, dtype)
    start = torch.tensor(start_np, dtype=dtype, device=dev)
    goal = torch.tensor(goal_np, dtype=dtype, device=dev)
    th0 = straight_line_traj(start[:, :2], goal[:, :2],
                             pp["total_time_sec"], T)
    sdfb = sdf.expand(B, *sdf.shape)
    robot = make_robot(robot_data)
    planner = GPMP2Planner(gp, obs, pp, _common.env_params(env), robot,
                           dtype=dtype, device=dev)
    # The graph error of a batch (one lookup), for the seeds and the plans.
    errors = DiffGPMP2Planner(gp, obs, pp, opt, _common.env_params(env),
                              robot, dtype=dtype, device=dev).error_batch
    err_seed = errors(th0, start, goal, sdfb)
    out = {}
    for name, kw in RUNS.items():
        r = planner.plan_multistart(start, goal, th0, sdfb, optim, **kw)
        out[name] = {
            "err_init": err_seed,
            "err_final": errors(r.th, start, goal, sdfb),
            "contact_free": r.contact_free, "k_best": r.k_best,
            "iters": r.iters, "th": r.th}
        print(f"contact-free ({name + ')':15s}:",
              _common.np_(r.contact_free).astype(int))
    print("winning restart per problem:",
          _common.np_(out["16 restarts"]["k_best"]))
    if args.plot:
        plot(img, th0, out)
    return out


def plot(img, th0, out):
    """The first problem that restart 0 leaves in contact and 16 restarts
    clear."""
    one, k = out["restart 0 only"], out["16 restarts"]
    gain = _common.np_(~one["contact_free"] & k["contact_free"])
    i = int(np.argmax(gain)) if gain.any() else 0
    plt, fig, ax = _common.figure(figsize=(6, 6))
    ax.imshow(img, cmap="gray", extent=(-5, 5, -5, 5), origin="upper")
    t0, t1, tk = (_common.np_(x[i]) for x in (th0, one["th"], k["th"]))
    ax.plot(t0[:, 0], t0[:, 1], "r--", label="straight seed")
    ax.plot(t1[:, 0], t1[:, 1], "m-", label="restart 0")
    ax.plot(tk[:, 0], tk[:, 1], "b-",
            label=f"best of {K} (restart {int(k['k_best'][i])})")
    ax.legend()
    _common.save(plt, fig, "multistart_example.png")


if __name__ == "__main__":
    main()
