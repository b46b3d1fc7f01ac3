"""Multi-start composition on the arm test set.

Port of the JAX package's ``tools/arm_multistart_eval.py``.  Completes the
arm campaign's comparison grid (``arm_campaign``): straight-seed static vs
learned planners, then the same planners under K-seed multistart
(``core.multistart``: joint-space sine-harmonic seed perturbations,
per-problem selection).  The point-robot composition study on an
articulated robot, which the reference cannot express.

Usage (after ``arm_campaign`` has populated --out):
  python -m dgpmp2_tpu_torch.tools.arm_multistart_eval \\
      --out runs/arm_campaign --restarts 16 --amp 1.2 \\
      [--cov_model eps_bounded_lr1] [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, multistart
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch
from dgpmp2_tpu_torch.tools import _common, arm_campaign
from dgpmp2_tpu_torch.tools._common import (dump_yaml, fixed_params,
                                            load_yaml, merged, straight)
from dgpmp2_tpu_torch.tools.arm_campaign import (ARM, COV, arm_spec,
                                                 batches_on, make_planner)

SIGMAS_MS = [0.02, 0.05, 0.1]


@torch.no_grad()
def eval_static_ms(spec, test, bs, sigma, restarts, amp, prune_iters, keep,
                   dev="cuda", dtype=torch.float32):
    """Static multistart plans of the test problems at ``sigma``; every
    batch draws its perturbations from the same seed (JAX's one
    ``PRNGKey(0)``)."""
    cfg = gn.OptimConfig(reg=0.1, max_iters=arm_campaign.ITERS)
    all_m = []
    for b in batches_on(test, bs, dev, dtype):
        th_sel = multistart.plan_multistart(
            spec, ARM, fixed_params(spec, ARM, b, dict(COV, cost_sigma=sigma)),
            straight(spec, b["start"], b["goal"]), b["sdf"], cfg,
            _common.generator(dev, 0), restarts=restarts, amp=amp,
            prune_iters=prune_iters, keep=keep).th
        all_m.append(evaluate_batch(spec, ARM,
                                    fixed_params(spec, ARM, b, COV), th_sel,
                                    b["th_opt"], b["sdf"]))
    return merged(all_m)


@torch.no_grad()
def eval_learned_ms(spec, test, bs, planner, variables, restarts, amp,
                    prune_iters, keep):
    dev = planner.device
    all_m = []
    for b in batches_on(test, bs, dev, planner.learn_cfg.dtype):
        params = fixed_params(spec, ARM, b, COV)
        th_sel = planner.plan_multistart(
            variables, params, straight(spec, b["start"], b["goal"]),
            b["sdf"], b["im"], _common.generator(dev, 0), restarts=restarts,
            amp=amp, prune_iters=prune_iters, keep=keep).th
        all_m.append(evaluate_batch(spec, ARM, params, th_sel, b["th_opt"],
                                    b["sdf"]))
    return merged(all_m)


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--restarts", type=int, default=16)
    p.add_argument("--amp", type=float, default=1.2)
    p.add_argument("--prune_iters", type=int, default=0)
    p.add_argument("--keep", type=int, default=0)
    p.add_argument("--cov_model", default=None,
                   help="campaign config name whose <name>_vars.npz to "
                        "compose with multi-start")
    p.add_argument("--cov_sigma", type=float, default=0.02,
                   help="static_init sigma the model was trained with")
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype

    with np.load(os.path.join(args.out, "data_test.npz")) as z:
        test = {k: z[k] for k in z.files}
    spec = arm_spec()

    out_file = os.path.join(args.out, "multistart_results.yaml")
    results = load_yaml(out_file) or {}
    for sigma in SIGMAS_MS:
        key = f"static_ms{args.restarts}_s{sigma}"
        if key in results:
            continue
        results[key] = eval_static_ms(spec, test, args.batch, sigma,
                                      args.restarts, args.amp,
                                      args.prune_iters, args.keep, dev, dtype)
        print(f"[{key}] solve={results[key]['solve_rate']:.3f} "
              f"cfree={results[key]['contact_free_rate']:.3f}", flush=True)
        dump_yaml(out_file, results)

    if args.cov_model:
        planner = make_planner(dict(
            learn_eps=True, eps_max=2 * COV["epsilon_dist"],
            static_init=(1.0, args.cov_sigma, COV["epsilon_dist"])),
            dev, dtype)
        # The template weights to restore into.
        b0 = batches_on(test, args.batch, dev, dtype)[0]
        tmpl = planner.init_variables(
            torch.Generator().manual_seed(0),
            planner.stack_inputs(b0["im"], b0["sdf"]),
            straight(spec, b0["start"], b0["goal"]))
        variables = checkpoints.load_flat_variables(
            os.path.join(args.out, f"{args.cov_model}_vars.npz"), tmpl)
        key = f"{args.cov_model}_ms{args.restarts}"
        results[key] = eval_learned_ms(spec, test, args.batch, planner,
                                       variables, args.restarts, args.amp,
                                       args.prune_iters, args.keep)
        print(f"[{key}] solve={results[key]['solve_rate']:.3f} "
              f"cfree={results[key]['contact_free_rate']:.3f}", flush=True)
        dump_yaml(out_file, results)

    for k, r in sorted(results.items()):
        print(f"{k}: solve={r['solve_rate']:.4f} "
              f"cfree={r['contact_free_rate']:.4f} "
              f"gp={r['avg_gp_error']:.4f}")
    return results


if __name__ == "__main__":
    main()
