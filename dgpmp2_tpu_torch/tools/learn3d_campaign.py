"""Learned covariances in 3-D: train ConvEncoder3D end to end and compare
against the best static sigma, the 2-D campaign protocol
(``learned_campaign``) on voxel worlds.

Port of the JAX package's ``tools/learn3d_campaign.py``.  No reference
analog (the reference is planar); this certifies that the differentiable
planning loop learns one dimension up.

Protocol (the 2-D eps_bounded recipe):
  1. Seeded 3-D datasets (``data.generate3d``): train + test splits.
  2. Static sigma sweep on the test split -> per-dataset best static.
  3. Train the bounded-eps model (learn_eps, eps = eps_max·sigmoid,
     static_init at the val sweep winner, task-only loss) with the TBPTT
     step; checkpoint = best-val-solve-rate epoch (90/10 batch split).
  4. Straight-seed eval of learned vs static-best on the held-out test
     split, canonical-margin judging (``plan3d_sweep.judge``).

Usage:
  python -m dgpmp2_tpu_torch.tools.learn3d_campaign --out runs/learn3d \\
      --family boxes3d --num_train 60 --num_test 16 --epochs 10 \\
      [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import generate3d
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.learn.losses import LossWeights
from dgpmp2_tpu_torch.learn.train import (TrainConfig, init_train_state,
                                          make_optimizer, make_train_step)
from dgpmp2_tpu_torch.robots import PointRobot3D
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import dump_yaml, fixed_params, straight
from dgpmp2_tpu_torch.tools.plan3d_sweep import judge

LIMS = (-5.0, 5.0)
SIZE = 32          # default --size (a multiple of 16 for the 4 pool stages)
T = 20             # default --t
EPS = 0.4
SIGMAS = (0.01, 0.02, 0.05, 0.1)
COV = dict(qc_inv=np.eye(3), cost_sigma=0.05, epsilon_dist=EPS,
           k_s=0.01, k_g=0.01)


def load_batches(root, batch_size, dev, dtype):
    """A split's problems as full batches on ``dev``: ``im`` the voxels."""
    probs = list(generate3d.load_split3d(root))
    n = len(probs) - len(probs) % batch_size
    batches = []
    for i in range(0, n, batch_size):
        chunk = probs[i: i + batch_size]
        b = _common.on_device({
            k: np.stack([c[j] for c in chunk]).astype(np.float32)
            for j, k in enumerate(("im", "sdf", "start", "goal", "th_opt"))},
            dev, dtype)
        b["cov_scalars"] = COV
        batches.append(b)
    return batches


@torch.no_grad()
def plan_static(spec, robot, batch, sigma):
    params = fixed_params(spec, robot, batch, dict(COV, cost_sigma=sigma))
    cfg = gn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    return gn.plan(spec, robot, params, straight(spec, batch["start"],
                                                 batch["goal"]),
                   batch["sdf"], cfg, track_best=True).best_th


def sweep(spec, robot, batches, res, tag):
    """Per-sigma solve and contact-free rates of the static planner."""
    rows = {}
    for sigma in SIGMAS:
        sol, cf = [], []
        for b in batches:
            s, c, _ = judge(spec, robot, plan_static(spec, robot, b, sigma),
                            b["sdf"], res)
            sol.append(s)
            cf.append(c)
        rows[sigma] = {"solve_rate": float(np.concatenate(sol).mean()),
                       "contact_free_rate": float(np.concatenate(cf).mean())}
        print(f"[static:{tag}] sigma={sigma}: {rows[sigma]}", flush=True)
    return rows


def learned_rates(planner, variables, batches, res):
    """(solve, contact-free) rates of the learned plans from the straight
    seed, 50 iterations with ``track_best``."""
    spec, robot = planner.spec, planner.robot
    sol, cf = [], []
    for b in batches:
        with torch.no_grad():
            th = planner.plan(variables, fixed_params(spec, robot, b, COV),
                              straight(spec, b["start"], b["goal"]),
                              b["sdf"], b["im"], max_iters=50,
                              track_best=True)[0]
        s, c, _ = judge(spec, robot, th, b["sdf"], res)
        sol.append(s)
        cf.append(c)
    return (float(np.concatenate(sol).mean()),
            float(np.concatenate(cf).mean()))


def make_planner(spec, sv_sigma, device, dtype) -> LearnedDiffGPMP2Planner:
    """The bounded-eps learned planner under LM, initialised at the
    val-chosen sigma.  Both arms run LM: fixed-damping GN collapses on
    dense worlds; dropout 0.1 and alpha 1e-4 follow the 2-D campaign
    (eps_bounded_lr1)."""
    lcfg = LearnedPlannerConfig(
        dynamics_mode="diag_identity", learn_eps=True, eps_max=2 * EPS,
        dropout_prob=0.1, static_init=(1.0, sv_sigma, EPS), dtype=dtype)
    return LearnedDiffGPMP2Planner(
        spec, PointRobot3D(), gn.OptimConfig(reg=0.1, max_iters=50,
                                             method="lm"), lcfg,
        device=device)


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--family", default="boxes3d")
    p.add_argument("--num_train", type=int, default=60)
    p.add_argument("--num_test", type=int, default=16)
    p.add_argument("--probs", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--t", type=int, default=T)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loss", default="task", choices=("task", "anchor"),
                   help="task: task-only ext loss (2-D eps_bounded recipe); "
                        "anchor: + mild expert-MSE term (2-D eps_anchor)")
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype
    size, t = args.size, args.t
    if size % 16:
        raise SystemExit("--size must be a multiple of 16 (4 pool stages)")
    os.makedirs(args.out, exist_ok=True)
    res = (LIMS[1] - LIMS[0]) / size

    # -- data -----------------------------------------------------------------
    for split, n, seed in (("train", args.num_train, args.seed),
                           ("test", args.num_test, args.seed + 1)):
        d = os.path.join(args.out, f"data_{split}")
        if not os.path.exists(os.path.join(d, "meta.yaml")):
            print(f"[data] {split}: {n} envs", flush=True)
            generate3d.generate_split3d(
                d, n, args.probs, args.family, size,
                np.random.default_rng(seed), t=t, max_iters=40,
                cov_scalars=dict(COV), device=dev)
    train_b = load_batches(os.path.join(args.out, "data_train"), args.batch,
                           dev, dtype)
    test_b = load_batches(os.path.join(args.out, "data_test"), args.batch,
                          dev, dtype)
    n_val = max(1, len(train_b) // 10)
    val_b, train_b = train_b[:n_val], train_b[n_val:]

    robot = PointRobot3D()
    spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                           x_lims=LIMS, y_lims=LIMS, z_lims=LIMS)

    # -- static sweeps ----------------------------------------------------------
    # Test split: the best-of-sweep ORACLE opponent row, reported beside the
    # learned model, never selected from.
    static_rows = sweep(spec, robot, test_b, res, "test")
    best_sigma = max(static_rows, key=lambda s: static_rows[s]["solve_rate"])
    # Val split: everything that feeds SELECTION (the training init and the
    # gate's static opponent) is chosen on val only.
    static_val_rows = sweep(spec, robot, val_b, res, "val")
    sv_sigma = max(static_val_rows,
                   key=lambda s: (static_val_rows[s]["solve_rate"],
                                  static_val_rows[s]["contact_free_rate"]))
    static_val_solve = static_val_rows[sv_sigma]["solve_rate"]

    # -- train ------------------------------------------------------------------
    planner = make_planner(spec, sv_sigma, dev, dtype)
    weights = LossWeights(
        pos_loss_weight=0.05 if args.loss == "anchor" else 0.0,
        ext_loss_weight=1.0, ext_obs_lambda=5.0)
    train_step = make_train_step(planner, weights, TrainConfig(T=10, tk=5))
    b0 = train_b[0]
    state = init_train_state(
        planner, make_optimizer("adam", {"alpha": 1e-4}),
        torch.Generator().manual_seed(args.seed),
        planner.stack_inputs(b0["im"], b0["sdf"]), b0["th_opt"])

    # The gate: the learned checkpoint is selected only when its val solve
    # rate beats the static baseline on the SAME val split, whose sigma is
    # val-chosen, so that the gate never sees the test split.
    print(f"[gate] static (val-chosen sigma {sv_sigma}) val solve_rate="
          f"{static_val_solve:.3f}", flush=True)

    best = (-1.0, None, -1)
    history = []
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_b))
        losses = []
        for j, k in enumerate(order):
            state, metrics = train_step(state, train_b[k],
                                        args.seed + epoch * 1000 + j)
            losses.append(float(metrics["loss"]))
        v_solve, v_cf = learned_rates(planner, state.variables, val_b, res)
        history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                        "val_solve": v_solve, "val_cf": v_cf})
        print(f"[train] epoch {epoch}: loss {np.mean(losses):.4f} "
              f"val_solve {v_solve:.3f} val_cf {v_cf:.3f}", flush=True)
        if v_solve > best[0]:
            best = (v_solve, _common.state_copy(state.variables), epoch)

    # -- final eval -------------------------------------------------------------
    state.variables.load_state_dict(best[1])
    t_solve, t_cf = learned_rates(planner, state.variables, test_b, res)
    use_learned = best[0] > static_val_solve
    bs = static_rows[best_sigma]
    # The selected-static row reports the VAL-chosen sigma's test metrics:
    # the test-tuned best_sigma would leak the test split through the gate.
    sv = static_rows[sv_sigma]
    sel_solve, sel_cf = ((t_solve, t_cf) if use_learned
                         else (sv["solve_rate"], sv["contact_free_rate"]))
    selected = "learned" if use_learned else "static"
    print(f"[gate] learned val {best[0]:.3f} vs static val "
          f"{static_val_solve:.3f} (sigma {sv_sigma}) -> selected="
          f"{selected}", flush=True)
    results = {
        "static": {str(k): v for k, v in static_rows.items()},
        "static_val": {str(k): v for k, v in static_val_rows.items()},
        "best_sigma": float(best_sigma),
        "learned": {"solve_rate": t_solve, "contact_free_rate": t_cf,
                    "val_epoch": int(best[2]), "loss": args.loss},
        "gate": {"learned_val_solve": float(best[0]),
                 "static_val_solve": static_val_solve,
                 "static_val_sigma": float(sv_sigma),
                 "selected": selected},
        "selected": {"solve_rate": sel_solve, "contact_free_rate": sel_cf},
        "history": history,
    }
    dump_yaml(os.path.join(args.out, "results.yaml"), results)
    table = "\n".join([
        f"# 3-D learned covariances — {args.family}, {size}³, "
        f"{args.num_train}+{args.num_test} envs x {args.probs}, "
        f"{args.epochs} epochs (val-selected epoch {best[2]})",
        "",
        f"Regenerate: `python -m dgpmp2_tpu_torch.tools.learn3d_campaign "
        f"--out {args.out} --family {args.family} --num_train "
        f"{args.num_train} --num_test {args.num_test} --epochs "
        f"{args.epochs} --seed {args.seed} --size {size} --t {t} --loss "
        f"{args.loss}`",
        "",
        "| config | solve_rate | contact_free_rate |",
        "|---|---|---|",
        f"| static_best (test-oracle sigma {best_sigma}) | "
        f"{bs['solve_rate']:.4f} | {bs['contact_free_rate']:.4f} |",
        f"| static val-chosen (sigma {sv_sigma}) | {sv['solve_rate']:.4f} | "
        f"{sv['contact_free_rate']:.4f} |",
        f"| eps_bounded-3d ({args.loss} loss, one model) | "
        f"{t_solve:.4f} | {t_cf:.4f} |",
        f"| **selected** (val gate: learned {best[0]:.3f} vs static "
        f"{static_val_solve:.3f} @ sigma {sv_sigma} -> {selected}) | "
        f"**{sel_solve:.4f}** | **{sel_cf:.4f}** |",
        "",
    ])
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(table)
    print(table)
    return results


if __name__ == "__main__":
    main()
