"""Learned-initialization experiment: can InitNet crack the forest family?

Port of the JAX package's ``tools/init_experiment.py``.  Forest is the
obstacle family where the static sigmas and the learned covariances sit at
solve_rate ~0.01 while the expert labels are collision-free by
construction.  The hypothesis: an *initialization* problem (the straight
seed threads dense clutter and Gauss-Newton converges to the nearest
colliding minimum).  The reference ships an initialization network for it
(``initialization_network.py``); this tool measures what a trained
``InitNet`` moves:

1. train InitNet supervised to the expert deltas
   (``learn.train_initializer``), epoch-selected by raw-init clearance on a
   held-out-from-train validation split;
2. on the family's test split, run the static-covariance sigma sweep twice,
   straight-line init vs InitNet init, with best-iterate selection and the
   canonical judge; the same with K-seed multistart;
3. report the expert ceiling (the labels under the same judge) and, with a
   trained covariance model (``--cov_model``), the combined learned-init +
   learned-covariance planner.

The InitNet checkpoint ``initnet_vars.npz`` keeps the JAX tool's layout
(flax leaves ``v0 … vN``), so that either package reads the other's.

Usage:
  python -m dgpmp2_tpu_torch.tools.init_experiment \\
      --data runs/campaign_all5/data_forest --out runs/init_forest \\
      --epochs 60 [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.core.multistart import plan_multistart
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch
from dgpmp2_tpu_torch.learn.train import dropout_seed
from dgpmp2_tpu_torch.learn.train_initializer import (make_train_fns,
                                                      solve_rate)
from dgpmp2_tpu_torch.models.init_net import InitNet
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import (dump_yaml, fixed_params, merged,
                                            on_device, straight)
from dgpmp2_tpu_torch.tools.learned_campaign import (COV, LABELS, SIGMAS,
                                                     learned_plan)
from dgpmp2_tpu_torch.tools.multistart_sweep import load_cov_model

X_LIMS, Y_LIMS = (-5.0, 5.0), (-5.0, 5.0)
TABLE_KEYS = ("solve_rate", "contact_free_rate", "avg_gp_error",
              "avg_max_penetration", "avg_coll_intensity", "avg_pos_mse")


def make_initnet(spec, im_size, args) -> InitNet:
    """The InitNet of ``spec``'s trajectories on ``im_size``² worlds, its
    weights drawn from ``args.seed``, on ``args.device`` in ``args.dtype``."""
    net = InitNet(2, (im_size, im_size), spec.num_traj_states,
                  spec.state_dim, dropout_prob=args.dropout)
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(args.seed))
    return net.to(device=args.device, dtype=args.dtype)


def train_initnet(root, out_dir, args, spec, robot):
    """Train InitNet (or load ``initnet_vars.npz``): the epoch of the best
    validation clearance is kept.  Returns (net, predict)."""
    dev, dtype = args.device, args.dtype
    ckpt = os.path.join(out_dir, "initnet_vars.npz")
    dataset = ds.PlanningDataset(root, mode="train", label_subdir=LABELS)
    meta = dataset.meta
    net = make_initnet(spec, meta["im_size"], args)
    optimizer = torch.optim.Adam(net.parameters(), args.alpha)
    train_step, predict, _ = make_train_fns(
        net, optimizer, spec.total_time_sec, spec.total_time_step, spec.dof)

    all_idxs = np.random.default_rng(123).permutation(len(dataset))
    n_val = max(args.batch, len(all_idxs) // 10)
    n_val -= n_val % args.batch
    val_idxs, idxs = all_idxs[:n_val], all_idxs[n_val:]
    val_batches = [on_device(b, dev, dtype) for b in ds.as_batches(
        dataset, val_idxs, args.batch, drop_remainder=True)]
    res = (X_LIMS[1] - X_LIMS[0]) / meta["im_size"]

    if os.path.exists(ckpt):
        checkpoints.load_flat_module(ckpt, net)
        print("[init] loaded checkpoint, skipping training")
        return net, predict

    def val_clearance():
        return float(np.mean([
            solve_rate(predict(vb), vb["sdf"], res, X_LIMS, Y_LIMS,
                       float(robot.sphere_radii[0]))
            for vb in val_batches]))

    rng_np = np.random.default_rng(1)
    best_rate, best_params = val_clearance(), _common.state_copy(net)
    print(f"[init] {len(idxs)} problems, batch {args.batch}, "
          f"{args.epochs} epochs; epoch -1 raw-init clearance={best_rate:.3f}")
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for b in ds.as_batches(dataset, idxs, args.batch, rng=rng_np,
                               drop_remainder=True):
            gen = torch.Generator(dev)
            gen.manual_seed(dropout_seed(args.seed,
                                         epoch * 1000 + len(losses), 0))
            losses.append(float(train_step(on_device(b, dev, dtype), gen)))
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            rate = val_clearance()
            tag = ""
            if rate > best_rate:
                best_rate, best_params = rate, _common.state_copy(net)
                tag = " *best*"
            print(f"[init] epoch {epoch}: loss={np.mean(losses):.4f} "
                  f"raw-init clearance={rate:.3f}{tag} "
                  f"({time.time() - t0:.1f}s)")
    print(f"[init] selected raw-init clearance={best_rate:.3f}")
    net.load_state_dict(best_params)
    checkpoints.save_flat_module(ckpt, net)
    return net, predict


@torch.no_grad()
def eval_static(spec, robot, test_batches, th0_fn, sigma):
    """Static-covariance planner metrics under the canonical judge; the
    init is whatever ``th0_fn(batch)`` returns."""
    cfg = gn.OptimConfig(reg=0.1, max_iters=50)
    cov = dict(COV, cost_sigma=sigma)
    all_m = []
    for b in test_batches:
        th = gn.plan(spec, robot, fixed_params(spec, robot, b, cov),
                     th0_fn(b), b["sdf"], cfg, track_best=True).best_th
        all_m.append(evaluate_batch(spec, robot,
                                    fixed_params(spec, robot, b, COV), th,
                                    b["th_opt"], b["sdf"]))
    return merged(all_m)


def eval_expert_ceiling(spec, robot, test_batches):
    """The labels themselves under the same judge: the attainable bound."""
    return merged([evaluate_batch(spec, robot,
                                  fixed_params(spec, robot, b, COV),
                                  b["th_opt"], b["th_opt"], b["sdf"])
                   for b in test_batches])


def eval_learned_with_init(planner, variables, test_batches, th0_fn):
    spec, robot = planner.spec, planner.robot
    all_m = []
    for b in test_batches:
        params_fix = fixed_params(spec, robot, b, COV)
        th = learned_plan(planner, variables, b, params_fix, th0_fn(b))
        all_m.append(evaluate_batch(spec, robot, params_fix, th, b["th_opt"],
                                    b["sdf"]))
    return merged(all_m)


@torch.no_grad()
def eval_multistart(spec, robot, test_batches, th0_fn, sigma, K, amp,
                    im_size, seed=0):
    """Static planner from K perturbed seeds per problem
    (``core.multistart.plan_multistart``, one (K·B) batch)."""
    cfg = gn.OptimConfig(reg=0.1, max_iters=50)
    cov = dict(COV, cost_sigma=sigma)
    all_m = []
    for bi, b in enumerate(test_batches):
        th_sel = plan_multistart(
            spec, robot, fixed_params(spec, robot, b, cov), th0_fn(b),
            b["sdf"], cfg, _common.generator(b["start"].device, seed, bi),
            restarts=K, amp=amp).th
        all_m.append(evaluate_batch(spec, robot,
                                    fixed_params(spec, robot, b, COV),
                                    th_sel, b["th_opt"], b["sdf"]))
    return merged(all_m)


def table(results: dict) -> str:
    lines = ["| config | " + " | ".join(k.replace("avg_", "")
                                        for k in TABLE_KEYS) + " |",
             "|" + "---|" * (len(TABLE_KEYS) + 1)]
    for name, m in results.items():
        if m is None:
            continue
        lines.append("| " + name + " | " +
                     " | ".join(f"{m[k]:.4f}" for k in TABLE_KEYS) + " |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--data", required=True,
                   help="family data root (with train/ and test/)")
    p.add_argument("--out", required=True)
    p.add_argument("--t", type=int, default=100)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--alpha", type=float, default=3e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--eval_batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restarts", type=int, default=16)
    p.add_argument("--amp", type=float, default=1.5)
    p.add_argument("--cov_model", default=None,
                   help="optional <name>:<vars.npz> of a trained covariance "
                        "model to combine with the learned init")
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype

    os.makedirs(args.out, exist_ok=True)
    spec = graph.GraphSpec(total_time_step=args.t)
    robot = PointRobot2D()

    _, predict = train_initnet(args.data, args.out, args, spec, robot)

    test_ds = ds.PlanningDataset(args.data, mode="test", label_subdir=LABELS)
    n = len(test_ds) - len(test_ds) % args.eval_batch
    test_batches = [on_device(b, dev, dtype) for b in ds.as_batches(
        test_ds, np.arange(n), args.eval_batch, drop_remainder=True)]
    print(f"[eval] {n} test problems in {len(test_batches)} batches")

    def straight_init(b):
        return straight(spec, b["start"], b["goal"])

    results = {"expert_ceiling": eval_expert_ceiling(spec, robot,
                                                     test_batches)}
    print(f"[eval] expert ceiling: solve_rate="
          f"{results['expert_ceiling']['solve_rate']:.3f} contact_free="
          f"{results['expert_ceiling']['contact_free_rate']:.3f}")

    # The raw predicted init (no optimization) under the same judge.
    results["raw_initnet"] = merged([
        evaluate_batch(spec, robot, fixed_params(spec, robot, b, COV),
                       predict(b), b["th_opt"], b["sdf"])
        for b in test_batches])
    print(f"[eval] raw initnet (no optimizer): solve_rate="
          f"{results['raw_initnet']['solve_rate']:.3f} contact_free="
          f"{results['raw_initnet']['contact_free_rate']:.3f}")

    def key(m):
        # forest's margin criterion is unsatisfiable (the expert ceiling
        # has solve_rate 0): break solve-rate ties by the contact criterion.
        return (m["solve_rate"], m["contact_free_rate"])

    inits = (("straight", straight_init), ("initnet", predict))
    for name, th0_fn in inits:
        best = None
        for sigma in SIGMAS:
            m = eval_static(spec, robot, test_batches, th0_fn, sigma)
            m["sigma"] = float(sigma)
            print(f"[eval:{name}] sigma={sigma}: solve_rate="
                  f"{m['solve_rate']:.3f} contact_free="
                  f"{m['contact_free_rate']:.3f}")
            if best is None or key(m) > key(best):
                best = m
        results[f"static_{name}_best"] = best

    for name, th0_fn in inits:
        best = None
        for sigma in SIGMAS:
            m = eval_multistart(spec, robot, test_batches, th0_fn, sigma,
                                args.restarts, args.amp,
                                test_ds.meta["im_size"], seed=args.seed)
            m["sigma"] = float(sigma)
            print(f"[eval:ms{args.restarts}_{name}] sigma={sigma}: "
                  f"solve_rate={m['solve_rate']:.3f} contact_free="
                  f"{m['contact_free_rate']:.3f}")
            if best is None or key(m) > key(best):
                best = m
        results[f"multistart{args.restarts}_{name}_best"] = best

    if args.cov_model:
        cname, planner, variables = load_cov_model(
            args.cov_model, args.t, test_batches[0], dev, dtype)
        for name, th0_fn in inits:
            m = eval_learned_with_init(planner, variables, test_batches,
                                       th0_fn)
            results[f"{cname}_{name}"] = m
            print(f"[eval:{cname}_{name}] solve_rate={m['solve_rate']:.3f} "
                  f"contact_free={m['contact_free_rate']:.3f}")

    dump_yaml(os.path.join(args.out, "results.yaml"), results)
    text = table(results)
    print(text)
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(text + "\n")
    return results


if __name__ == "__main__":
    main()
