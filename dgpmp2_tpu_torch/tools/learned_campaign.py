"""Learned-vs-static campaign: data → static sweep → train sweep → eval.

Port of the JAX package's ``tools/learned_campaign.py``.  The round-1 gap:
the learned planner only matched the best static covariance.  This tool
runs the full comparison on one card:

1. generate train/test datasets (batched expert, several obstacle families)
2. static-covariance sensitivity sweep on the held-out test split (the
   honest opponent, ``test_dataset_sensitivity.py`` semantics)
3. train several learned configs (loss-weight / dynamics-mode sweep, all
   ``static_init`` so learning refines the baseline instead of recovering)
4. evaluate each on the same test split with the reference metric suite
   (+ the margin-vs-contact split) and write a results table.

Usage:
  python -m dgpmp2_tpu_torch.tools.learned_campaign --out runs/campaign \\
      --num_train 250 --num_test 40 --probs 4 --families multi_obs forest \\
      --epochs 80 [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data import generate
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.learn.losses import LossWeights
from dgpmp2_tpu_torch.learn.train import (TrainConfig, init_train_state,
                                          make_optimizer, make_train_step)
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import (dump_yaml, fixed_params,
                                            load_yaml, merged, on_device,
                                            straight)

COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4,
           k_s=0.01, k_g=0.01)
SIGMAS = [0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0]
LABELS = "opt_trajs_gpmp2"

# name -> (LossWeights overrides, LearnedPlannerConfig overrides); the
# history of each recipe is told beside the JAX tool's table.
CONFIGS = {
    "ref_loss": (dict(ext_loss_weight=0.01), {}),
    "obs_heavy": (dict(pos_loss_weight=0.3, ext_loss_weight=0.3,
                       ext_obs_lambda=5.0), {}),
    "task_only": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                       ext_obs_lambda=5.0), {}),
    # Start at the strongest static covariance (sigma=0.02) and refine with
    # the task loss only: the labels were made at sigma=0.05.
    "task_s02": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                      ext_obs_lambda=5.0),
                 dict(static_init=(1.0, 0.02, COV["epsilon_dist"]))),
    # Learned per-state safety margin eps on top of the covariances.
    "task_eps": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                      ext_obs_lambda=5.0), dict(learn_eps=True)),
    # Smooth-max penetration surrogate (losses.smooth_max_penetration).
    "task_maxpen": (dict(pos_loss_weight=0.0, ext_loss_weight=0.1,
                         ext_obs_lambda=1.0, max_pen_weight=5.0),
                    dict(static_init=(1.0, 0.02, COV["epsilon_dist"]))),
    "task_maxpen01": (dict(pos_loss_weight=0.0, ext_loss_weight=0.1,
                           ext_obs_lambda=1.0, max_pen_weight=5.0),
                      dict(static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    # eps learning anchored by a mild expert-imitation term.
    "eps_anchor": (dict(pos_loss_weight=0.05, ext_loss_weight=1.0,
                        ext_obs_lambda=5.0), dict(learn_eps=True)),
    "eps_maxpen": (dict(pos_loss_weight=0.0, ext_loss_weight=0.1,
                        ext_obs_lambda=1.0, max_pen_weight=5.0),
                   dict(learn_eps=True,
                        static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    "eps_maxpen_anchor": (dict(pos_loss_weight=0.05, ext_loss_weight=1.0,
                               ext_obs_lambda=1.0, max_pen_weight=3.0),
                          dict(learn_eps=True,
                               static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    # Bounded eps (eps = eps_max·sigmoid): the planner can at most double
    # its margins, so solve-rate gains come from clearance.
    "eps_bounded": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                         ext_obs_lambda=5.0),
                    dict(learn_eps=True, eps_max=2 * COV["epsilon_dist"],
                         static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    "eps_bounded_maxpen": (dict(pos_loss_weight=0.05, ext_loss_weight=1.0,
                                ext_obs_lambda=2.0, max_pen_weight=3.0),
                           dict(learn_eps=True,
                                eps_max=2 * COV["epsilon_dist"],
                                static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    # The same recipe at a 3x lower step size.
    "eps_bounded_lr1": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                             ext_obs_lambda=5.0, _alpha=1e-4),
                        dict(learn_eps=True, eps_max=2 * COV["epsilon_dist"],
                             static_init=(1.0, 0.01, COV["epsilon_dist"]))),
    # Recurrent head: one GRU step per GN iteration.
    "eps_bounded_gru": (dict(pos_loss_weight=0.0, ext_loss_weight=1.0,
                             ext_obs_lambda=5.0),
                        dict(learn_eps=True, eps_max=2 * COV["epsilon_dist"],
                             static_init=(1.0, 0.01, COV["epsilon_dist"]),
                             model_type="rnn_gru")),
}
TABLE_KEYS = ["solve_rate", "contact_free_rate", "avg_gp_error",
              "avg_sg_error", "avg_max_penetration", "avg_coll_intensity",
              "avg_pos_mse"]


def gen_data(out, families, num_train, num_test, probs, t, seed=0,
             device="cuda"):
    """Each family's ``data_<family>/{train,test}`` under ``out`` (kept where
    it exists); the LM expert, numpy seed ``seed + 1000·(i+1)`` for the i-th
    family.  Returns the family roots."""
    spec = graph.GraphSpec(total_time_step=t)
    robot = PointRobot2D()
    # LM expert: step rejection keeps the optimizer stable in clutter.
    cfg = gn.OptimConfig(reg=0.1, max_iters=60, method="lm")
    roots = []
    for fi, fam in enumerate(families):
        root = os.path.join(out, f"data_{fam}")
        roots.append(root)
        if os.path.exists(os.path.join(root, "test", "meta.yaml")):
            print(f"[data] {fam}: exists, skipping")
            continue
        rng = np.random.default_rng(seed + 1000 * (fi + 1))
        for mode, n in (("train", num_train), ("test", num_test)):
            t0 = time.time()
            generate.generate_split(
                os.path.join(root, mode), n, probs, fam, 128, rng, spec,
                robot, cfg, COV, device=device)
            print(f"[data] {fam}/{mode}: {n} envs x {probs} in "
                  f"{time.time() - t0:.0f}s")
    return roots


def load_test_batches(roots, batch_size, dev, dtype):
    """The pooled test split as full batches on ``dev``."""
    dataset = ds.PlanningDatasetMulti(roots, mode="test", label_subdir=LABELS)
    return [on_device(b, dev, dtype) for b in ds.as_batches(
        dataset, np.arange(len(dataset)), batch_size, drop_remainder=True)]


def load_family_batches(root, batch_size, dev, dtype):
    """All test problems of ONE family root as batches (the per-family
    breakdown of a multi-family generalist run)."""
    dataset = ds.PlanningDataset(root, mode="test", label_subdir=LABELS)
    n = len(dataset) - len(dataset) % batch_size
    return [on_device(b, dev, dtype) for b in ds.as_batches(
        dataset, np.arange(n), batch_size, drop_remainder=True)]


@torch.no_grad()
def static_sweep(spec, robot, test_batches, out_file):
    """Best-static opponent: per-sigma metrics on the test split (read back
    from ``out_file`` where it exists)."""
    cached = load_yaml(out_file)
    if cached is not None:
        return cached
    cfg = gn.OptimConfig(reg=0.1, max_iters=50)
    results = {}
    for sigma in SIGMAS:
        all_m = []
        for b in test_batches:
            params = fixed_params(spec, robot, b, dict(COV, cost_sigma=sigma))
            # Best non-colliding iterate by GP-MSE (test_planner.py:253-262),
            # symmetric with eval_learned.
            th = gn.plan(spec, robot, params, straight(spec, b["start"],
                                                       b["goal"]),
                         b["sdf"], cfg, track_best=True).best_th
            # Metrics always under the CANONICAL covariances, so that every
            # row is comparable (sigma changes the planner, not the judge).
            all_m.append(evaluate_batch(spec, robot,
                                        fixed_params(spec, robot, b, COV),
                                        th, b["th_opt"], b["sdf"]))
        results[float(sigma)] = merged(all_m)
        print(f"[static] sigma={sigma}: solve_rate="
              f"{results[float(sigma)]['solve_rate']:.3f} contact_free="
              f"{results[float(sigma)]['contact_free_rate']:.3f}")
    dump_yaml(out_file, results)
    return results


def best_of(sweep: dict):
    """The sweep's best sigma: solve rate first, then contact-free."""
    return max(sweep, key=lambda s: (sweep[s]["solve_rate"],
                                     sweep[s]["contact_free_rate"]))


def make_planner(t, lcfg_overrides, max_iters=50, device="cuda",
                 dtype=torch.float32) -> LearnedDiffGPMP2Planner:
    spec = graph.GraphSpec(total_time_step=t)
    kw = dict(dynamics_mode="diag_identity", dropout_prob=0.1,
              static_init=(1.0, COV["cost_sigma"], COV["epsilon_dist"]),
              dtype=dtype)
    kw.update(lcfg_overrides)
    return LearnedDiffGPMP2Planner(
        spec, PointRobot2D(), gn.OptimConfig(reg=0.1, max_iters=max_iters),
        LearnedPlannerConfig(**kw), device=device)


@torch.no_grad()
def learned_plan(planner, variables, batch, params_fix, th0=None):
    """The learned plan of a batch, 50 iterations with ``track_best``, from
    the straight seed unless ``th0`` is given."""
    if th0 is None:
        th0 = straight(planner.spec, batch["start"], batch["goal"])
    return planner.plan(variables, params_fix, th0, batch["sdf"],
                        batch["im"], max_iters=50, track_best=True)[0]


def _val_solve_rate(planner, variables, spec, robot, val_batches):
    """Held-out-from-train solve rate for epoch selection (the metric the
    comparison is judged on; the reference's eval_epoch validation,
    ``train_planner.py:458-468``)."""
    rates = []
    for b in val_batches:
        params_fix = fixed_params(spec, robot, b, COV)
        th = learned_plan(planner, variables, b, params_fix)
        m = evaluate_batch(spec, robot, params_fix, th, b["th_opt"], b["sdf"])
        rates.append(~m["in_coll"].astype(bool))
    return float(np.mean(np.concatenate(rates)))


def train_config(name, w_over, lcfg_over, roots, args, out_dir):
    """Train one config (or load its ``<name>_vars.npz``): the epoch of the
    best validation solve rate is kept, and gated against the best static
    sigma on the same validation split.  Returns (planner, state, gate)."""
    dev, dtype = args.device, args.dtype
    w_over = dict(w_over)
    alpha = w_over.pop("_alpha", args.alpha)  # per-config step size
    ckpt = os.path.join(out_dir, f"{name}_vars.npz")
    planner = make_planner(args.t, lcfg_over, device=dev, dtype=dtype)
    spec, robot = planner.spec, planner.robot
    dataset = ds.PlanningDatasetMulti(roots, mode="train", label_subdir=LABELS)
    # 90/10 train/val split (val only for epoch selection, never the test
    # split).
    all_idxs = np.random.default_rng(123).permutation(len(dataset))
    n_val = max(args.batch, len(all_idxs) // 10)
    n_val -= n_val % args.batch
    val_idxs, idxs = all_idxs[:n_val], all_idxs[n_val:]
    val_batches = [on_device(b, dev, dtype) for b in ds.as_batches(
        dataset, val_idxs, args.batch, drop_remainder=True)]
    rng_np = np.random.default_rng(1)

    train_step = make_train_step(
        planner, LossWeights(**w_over),
        TrainConfig(T=args.unroll, tk=args.tk, use_inter_loss=True))
    sample = on_device(next(ds.as_batches(dataset, idxs, args.batch)), dev,
                       dtype)
    state = init_train_state(
        planner, make_optimizer("adam", {"alpha": alpha}),
        torch.Generator().manual_seed(0),
        planner.stack_inputs(sample["im"], sample["sdf"]), sample["th_opt"])
    gate_file = os.path.join(out_dir, f"{name}_gate.yaml")

    def val_gate_opponent():
        """The best-of-9-sigmas static planner on the SAME val split the
        learned checkpoint is selected on, cached once per out_dir (the
        split is deterministic, rng 123, so every config shares it)."""
        sv = static_sweep(spec, robot, val_batches,
                          os.path.join(out_dir, "static_val.yaml"))
        sv_sigma = best_of(sv)
        return float(sv_sigma), float(sv[sv_sigma]["solve_rate"])

    def gate_of(rate, static_val, sv_sigma):
        return {"learned_val_solve": float(rate),
                "static_val_solve": float(static_val),
                "static_val_sigma": sv_sigma,
                "selected": "learned" if rate > static_val else "static"}

    if os.path.exists(ckpt):
        checkpoints.load_flat_variables(ckpt, state.variables)
        gate = load_yaml(gate_file)
        if gate is not None:
            print(f"[train:{name}] loaded checkpoint, skipping training")
        else:
            # A checkpoint without a gate record: regenerate the record from
            # the loaded weights rather than emit a table with no selected
            # row.
            print(f"[train:{name}] loaded checkpoint with NO gate record — "
                  "regenerating the val gate from the loaded variables")
            sv_sigma, static_val = val_gate_opponent()
            rate = _val_solve_rate(planner, state.variables, spec, robot,
                                   val_batches)
            gate = gate_of(rate, static_val, sv_sigma)
            dump_yaml(gate_file, gate)
            print(f"[train:{name}] regenerated gate: learned val "
                  f"{rate:.3f} vs static val {static_val:.3f} "
                  f"(sigma {sv_sigma}) -> {gate['selected']}")
        return planner, state, gate

    sv_sigma, static_val = val_gate_opponent()
    print(f"[train:{name}] {len(idxs)} problems, batch {args.batch}, "
          f"{args.epochs} epochs")
    hist = []
    best_rate = _val_solve_rate(planner, state.variables, spec, robot,
                                val_batches)
    best_vars = _common.state_copy(state.variables)
    print(f"[train:{name}] epoch -1 (init): val solve_rate={best_rate:.3f}")
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for b in ds.as_batches(dataset, idxs, args.batch, rng=rng_np,
                               drop_remainder=True):
            b = on_device(b, dev, dtype)
            b["cov_scalars"] = COV
            state, m = train_step(state, b, 0)
            losses.append(float(m["loss"]))
        hist.append(float(np.mean(losses)))
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            rate = _val_solve_rate(planner, state.variables, spec, robot,
                                   val_batches)
            tag = ""
            if rate > best_rate:
                best_rate = rate
                best_vars = _common.state_copy(state.variables)
                tag = " *best*"
            print(f"[train:{name}] epoch {epoch}: loss={hist[-1]:.4f} "
                  f"val solve_rate={rate:.3f}{tag} ({time.time() - t0:.1f}s)")
        elif epoch % 10 == 0:
            print(f"[train:{name}] epoch {epoch}: loss={hist[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
    state.variables.load_state_dict(best_vars)
    # Val gate: the learned checkpoint is "selected" only when it beats the
    # static val baseline on the same split; otherwise the campaign emits
    # the static config as the selected model.
    gate = gate_of(best_rate, static_val, sv_sigma)
    print(f"[train:{name}] selected val solve_rate={best_rate:.3f}; gate "
          f"vs static val {static_val:.3f} (sigma {sv_sigma}) -> "
          f"{gate['selected']}")
    checkpoints.save_flat_variables(ckpt, state.variables)
    dump_yaml(gate_file, gate)
    dump_yaml(os.path.join(out_dir, f"{name}_train_loss.yaml"), hist)
    return planner, state, gate


def eval_learned(planner, state, spec, robot, test_batches):
    all_m = []
    for b in test_batches:
        params_fix = fixed_params(spec, robot, b, COV)
        th = learned_plan(planner, state.variables, b, params_fix)
        all_m.append(evaluate_batch(spec, robot, params_fix, th, b["th_opt"],
                                    b["sdf"]))
    return merged(all_m)


def results_table(results: dict, keys=TABLE_KEYS) -> str:
    lines = ["| config | " + " | ".join(keys) + " |",
             "|---|" + "---|" * len(keys)]
    for name, r in results.items():
        lines.append(f"| {name} | " + " | ".join(
            f"{r.get(k, float('nan')):.4f}" for k in keys) + " |")
    return "\n".join(lines)


def family_table(by_family: dict) -> str:
    fams = list(by_family)
    cfg_rows = sorted({c for rows in by_family.values() for c in rows})
    cfg_rows = ["static_best"] + [c for c in cfg_rows if c != "static_best"]
    blocks = []
    for metric in ("solve_rate", "contact_free_rate"):
        lines = [f"**{metric}** (one generalist model; static_best = "
                 "each family's own best sigma)", "",
                 "| config | " + " | ".join(fams) + " |",
                 "|---|" + "---|" * len(fams)]
        for c in cfg_rows:
            cells = [f"{by_family[f][c][metric]:.4f}"
                     if c in by_family[f] else "—" for f in fams]
            lines.append(f"| {c} | " + " | ".join(cells) + " |")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--families", nargs="+", default=["multi_obs", "forest"])
    p.add_argument("--num_train", type=int, default=250)
    p.add_argument("--num_test", type=int, default=40)
    p.add_argument("--probs", type=int, default=4)
    p.add_argument("--t", type=int, default=100)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--alpha", type=float, default=3e-4)
    p.add_argument("--unroll", type=int, default=10)
    p.add_argument("--tk", type=int, default=5)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--configs", nargs="+", default=list(CONFIGS))
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype

    os.makedirs(args.out, exist_ok=True)
    roots = gen_data(args.out, args.families, args.num_train, args.num_test,
                     args.probs, args.t, device=dev)
    spec = graph.GraphSpec(total_time_step=args.t)
    robot = PointRobot2D()
    test_batches = load_test_batches(roots, args.batch, dev, dtype)
    print(f"[eval] {len(test_batches)} test batches of {args.batch}")

    static = static_sweep(spec, robot, test_batches,
                          os.path.join(args.out, "static_sensitivity.yaml"))
    best_sigma = best_of(static)
    print(f"[static] best sigma={best_sigma}: {static[best_sigma]}")

    # Per-family breakdown of a multi-family (generalist) run: each family
    # is judged against ITS OWN best static sigma.
    by_family, fam_batches = {}, {}
    if len(roots) > 1:
        # One batch per family when it fits: covers every test problem.
        fam_bs = min(512, args.num_test * args.probs)
        for fam, root in zip(args.families, roots):
            fam_batches[fam] = load_family_batches(root, fam_bs, dev, dtype)
            fam_static = static_sweep(
                spec, robot, fam_batches[fam],
                os.path.join(args.out, f"static_sensitivity_{fam}.yaml"))
            fb = best_of(fam_static)
            by_family[fam] = {"static_best": {"sigma": fb, **fam_static[fb]}}
            print(f"[static:{fam}] best sigma={fb}: "
                  f"solve_rate={fam_static[fb]['solve_rate']:.3f}")

    # Merge with earlier runs, so that incremental --configs invocations
    # extend the same results table.
    results_file = os.path.join(args.out, "results.yaml")
    results = load_yaml(results_file) or {}
    results["static_best"] = {"sigma": best_sigma, **static[best_sigma]}
    by_family_file = os.path.join(args.out, "results_by_family.yaml")
    for fam, rows in (load_yaml(by_family_file) or {}).items():
        by_family.setdefault(fam, {}).update(
            {k: v for k, v in rows.items() if k not in by_family[fam]})
    for name in args.configs:
        w_over, lcfg_over = CONFIGS[name]
        planner, state, gate = train_config(name, w_over, lcfg_over, roots,
                                            args, args.out)
        summary = eval_learned(planner, state, spec, robot, test_batches)
        if gate is not None:
            summary["val_gate"] = gate
        results[name] = summary
        print(f"[eval:{name}] {json.dumps(summary)}")
        dump_yaml(results_file, results)
        for fam, batches in fam_batches.items():
            fam_summary = eval_learned(planner, state, spec, robot, batches)
            by_family[fam][name] = fam_summary
            print(f"[eval:{name}:{fam}] solve_rate="
                  f"{fam_summary['solve_rate']:.3f} contact_free="
                  f"{fam_summary['contact_free_rate']:.3f}")
        if by_family:
            dump_yaml(by_family_file, by_family)

    table = results_table(results)
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(table + "\n")
    print(table)
    if by_family:
        fam_table = family_table(by_family)
        with open(os.path.join(args.out, "per_family.md"), "w") as fp:
            fp.write(fam_table + "\n")
        print(fam_table)
    return {"results": results, "by_family": by_family,
            "test_batches": len(test_batches)}


if __name__ == "__main__":
    main()
