"""Multi-start vs straight-seed static planning across the families.

Port of the JAX package's ``tools/multistart_sweep.py``: for each family's
held-out test split, sweep the static sigmas with K perturbed seeds per
problem and report the best row per family under both selection keys
(solve_rate first and contact_free first), next to the straight-seed
static best of the campaign's sensitivity sweep; with ``--cov_model``, the
learned covariances composed with the same multistart seeds.

Usage:
  python -m dgpmp2_tpu_torch.tools.multistart_sweep \\
      --data_root runs/campaign_all5 --families multi_obs forest passage \\
      tar_pit mixed_clutter --out runs/multistart_sweep --restarts 16 \\
      [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.core import seeds as seeds_lib
from dgpmp2_tpu_torch.core.multistart import plan_multistart
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import (dump_yaml, fixed_params,
                                            load_yaml, merged, on_device,
                                            straight)
from dgpmp2_tpu_torch.tools.learned_campaign import (CONFIGS, COV, LABELS,
                                                     SIGMAS, make_planner)


def load_batches(root, batch_size, dev, dtype, limit=None):
    """A family's test split as full batches on ``dev``."""
    test_ds = ds.PlanningDataset(root, mode="test", label_subdir=LABELS)
    # Tiny (smoke-scale) splits: shrink the batch rather than dropping
    # every problem to the remainder.
    batch_size = min(batch_size, len(test_ds))
    n = len(test_ds) - len(test_ds) % batch_size
    if limit is not None:
        n = min(n, limit)
    return [on_device(b, dev, dtype) for b in ds.as_batches(
        test_ds, np.arange(n), batch_size, drop_remainder=True)]


def rrt_seed_pool(batches, spec, n_seeds, plan_time, clearance, seed):
    """Per-batch informed RRT* seed pools (E, B, T+1, 4) on the batches'
    device and dtype, made once for the sigma sweep: seeds depend only on
    the problems (``core.seeds``; the reference RRT*→GPMP2 recipe).
    Returns (pools, seeds found)."""
    pools, n_found = [], 0
    for bi, b in enumerate(batches):
        per = []
        for k in range(n_seeds):
            s, found = seeds_lib.rrt_seed_batch(
                b["sdf"].cpu().numpy(), b["start"].cpu().numpy(),
                b["goal"].cpu().numpy(), spec.x_lims, spec.y_lims,
                spec.total_time_sec, spec.num_traj_states,
                clearance=clearance, plan_time=plan_time,
                seed=seed + 7919 * k + 104729 * bi)
            per.append(s)
            n_found += int(found.sum())
        pools.append(torch.as_tensor(np.stack(per), dtype=b["start"].dtype,
                                     device=b["start"].device))
    total = n_seeds * sum(b["start"].shape[0] for b in batches)
    print(f"  rrt seeds: {n_found}/{total} found", flush=True)
    return pools, n_found


@torch.no_grad()
def eval_family(root, spec, robot, K, amp, batch_size, seed, prune_iters=0,
                keep=0, sigmas=None, rrt_seeds=0, rrt_plan_time=1.0,
                rrt_clearance=0.2, dev="cuda", dtype=torch.float32,
                pools=None):
    """``{sigma: summary}`` of static multistart plans on a family's test
    split (its RRT* ``pools`` made here unless given)."""
    batches = load_batches(root, batch_size, dev, dtype)
    cfg = gn.OptimConfig(reg=0.1, max_iters=50)
    if rrt_seeds and pools is None:
        pools, _ = rrt_seed_pool(batches, spec, rrt_seeds, rrt_plan_time,
                                 rrt_clearance, seed)
    rows = {}
    for sigma in (SIGMAS if sigmas is None else sigmas):
        cov = dict(COV, cost_sigma=sigma)
        all_m = []
        for bi, b in enumerate(batches):
            th = plan_multistart(
                spec, robot, fixed_params(spec, robot, b, cov),
                straight(spec, b["start"], b["goal"]), b["sdf"], cfg,
                _common.generator(b["start"].device, seed, bi), restarts=K,
                amp=amp, prune_iters=prune_iters, keep=keep,
                extra_seeds=pools[bi] if rrt_seeds else None).th
            all_m.append(evaluate_batch(spec, robot,
                                        fixed_params(spec, robot, b, COV),
                                        th, b["th_opt"], b["sdf"]))
        m = merged(all_m)
        m["sigma"] = float(sigma)
        rows[float(sigma)] = m
        print(f"  sigma={sigma}: solve_rate={m['solve_rate']:.3f} "
              f"contact_free={m['contact_free_rate']:.3f}", flush=True)
    return rows


@torch.no_grad()
def eval_family_learned_ms(root, planner, variables, K, amp, batch_size,
                           seed, prune_iters=0, keep=0):
    """Learned covariances composed with multistart seeds: the (K·B)-tiled
    batch goes through ``LearnedDiffGPMP2Planner.plan_multistart`` (the
    head predicts per candidate)."""
    spec, robot = planner.spec, planner.robot
    batches = load_batches(root, batch_size, planner.device,
                           planner.learn_cfg.dtype)
    all_m = []
    for bi, b in enumerate(batches):
        params = fixed_params(spec, robot, b, COV)
        out = planner.plan_multistart(
            variables, params, straight(spec, b["start"], b["goal"]),
            b["sdf"], b["im"], _common.generator(b["start"].device, seed, bi),
            restarts=K, amp=amp, max_iters=50, prune_iters=prune_iters,
            keep=keep)
        all_m.append(evaluate_batch(spec, robot, params, out.th, b["th_opt"],
                                    b["sdf"]))
    return merged(all_m)


def load_cov_model(cov_model, t, batch, dev, dtype):
    """``<config>:<vars.npz>`` -> (config name, planner, variables): the
    flat checkpoint loaded into the config's planner."""
    cname, vpath = cov_model.split(":", 1)
    planner = make_planner(t, CONFIGS[cname][1], device=dev, dtype=dtype)
    variables = planner.init_variables(
        torch.Generator().manual_seed(0),
        planner.stack_inputs(batch["im"], batch["sdf"]), batch["th_opt"])
    return cname, planner, checkpoints.load_flat_variables(vpath, variables)


def table(results: dict, args) -> str:
    lines = [f"**multi-start K={args.restarts}** (straight base; static = "
             "best of 9 sigmas per family)",
             "", "| family | solve_rate | contact_free (same row) | "
             "best contact_free (any sigma) | learned+ms solve | "
             "learned+ms contact_free |", "|---|---|---|---|---|---|"]
    for fam, r in results.items():
        bs, bc = r.get("best_solve"), r.get("best_contact_free")
        suffix = f"_ms{args.restarts}"
        if args.keep:
            suffix += f"_p{args.prune_iters}k{args.keep}"
        lm = next((v for k, v in r.items() if k.endswith(suffix)), None)
        lines.append(
            f"| {fam} | "
            + (f"{bs['solve_rate']:.4f} | {bs['contact_free_rate']:.4f} | "
               if bs else "— | — | ")
            + (f"{bc['contact_free_rate']:.4f} | " if bc else "— | ")
            + (f"{lm['solve_rate']:.4f} | {lm['contact_free_rate']:.4f} |"
               if lm else "— | — |"))
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--families", nargs="+",
                   default=["multi_obs", "forest", "passage", "tar_pit",
                            "mixed_clutter"])
    p.add_argument("--out", required=True)
    p.add_argument("--t", type=int, default=100)
    p.add_argument("--restarts", type=int, default=16)
    p.add_argument("--amp", type=float, default=1.5)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prune_iters", type=int, default=0,
                   help="staged pruning: phase-1 iterations")
    p.add_argument("--keep", type=int, default=0,
                   help="staged pruning: survivors per problem")
    p.add_argument("--rrt_seeds", type=int, default=0,
                   help="informed RRT* seeds appended per problem "
                        "(host-side native planner; core/seeds.py)")
    p.add_argument("--rrt_plan_time", type=float, default=1.0,
                   help="per-problem RRT* budget, seconds")
    p.add_argument("--rrt_clearance", type=float, default=0.2,
                   help="RRT* validity clearance (m); robot radius + margin")
    p.add_argument("--cov_model", default=None,
                   help="<config>:<vars.npz> learned covariance model to "
                        "compose with multi-start seeds")
    p.add_argument("--no_static", action="store_true",
                   help="skip the static sigma sweep (learned-only pass)")
    p.add_argument("--sigmas", nargs="+", type=float, default=None,
                   help="restrict the static sweep to these sigmas "
                        "(default: all nine)")
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype

    os.makedirs(args.out, exist_ok=True)
    spec = graph.GraphSpec(total_time_step=args.t)
    robot = PointRobot2D()
    results_path = os.path.join(args.out, "results.yaml")
    results = load_yaml(results_path) or {}

    if not args.no_static:
        for fam in args.families:
            root = os.path.join(args.data_root, f"data_{fam}")
            print(f"[{fam}] K={args.restarts} sigma sweep", flush=True)
            t0 = time.time()
            rows = eval_family(root, spec, robot, args.restarts, args.amp,
                               args.batch, args.seed, args.prune_iters,
                               args.keep, args.sigmas,
                               rrt_seeds=args.rrt_seeds,
                               rrt_plan_time=args.rrt_plan_time,
                               rrt_clearance=args.rrt_clearance, dev=dev,
                               dtype=dtype)
            # RRT*-seeded rows live under their own keys, so that the
            # informed and uninformed sweeps are reported apart.
            tag = f"_rrt{args.rrt_seeds}" if args.rrt_seeds else ""
            skey = f"by_sigma{tag}"
            bs_key, bc_key = f"best_solve{tag}", f"best_contact_free{tag}"
            rows_all = dict(results.get(fam, {}).get(skey, {}))
            rows_all.update(rows)
            best_solve = max(rows_all.values(),
                             key=lambda m: (m["solve_rate"],
                                            m["contact_free_rate"]))
            best_cf = max(rows_all.values(),
                          key=lambda m: m["contact_free_rate"])
            results.setdefault(fam, {}).update(
                {skey: rows_all, bs_key: best_solve, bc_key: best_cf})
            print(f"[{fam}] best solve_rate={best_solve['solve_rate']:.3f} "
                  f"(sigma {best_solve['sigma']}), best contact_free="
                  f"{best_cf['contact_free_rate']:.3f} (sigma "
                  f"{best_cf['sigma']}) in {time.time() - t0:.0f}s",
                  flush=True)

    if args.cov_model:
        root0 = os.path.join(args.data_root, f"data_{args.families[0]}")
        b0 = load_batches(root0, args.batch, dev, dtype, limit=args.batch)[0]
        cname, planner, variables = load_cov_model(args.cov_model, args.t, b0,
                                                   dev, dtype)
        for fam in args.families:
            root = os.path.join(args.data_root, f"data_{fam}")
            t0 = time.time()
            m = eval_family_learned_ms(root, planner, variables,
                                       args.restarts, args.amp, args.batch,
                                       args.seed, args.prune_iters,
                                       args.keep)
            key = f"{cname}_ms{args.restarts}"
            if args.keep:
                key += f"_p{args.prune_iters}k{args.keep}"
            results.setdefault(fam, {})[key] = m
            print(f"[{fam}] {cname}+ms{args.restarts}: solve_rate="
                  f"{m['solve_rate']:.3f} contact_free="
                  f"{m['contact_free_rate']:.3f} in {time.time() - t0:.0f}s",
                  flush=True)

    dump_yaml(results_path, results)
    text = table(results, args)
    print(text)
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(text + "\n")
    return results


if __name__ == "__main__":
    main()
