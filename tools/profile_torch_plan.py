#!/usr/bin/env python3
"""Where the time of one GN iteration of the PyTorch port goes, on a GPU.

    python3 tools/profile_torch_plan.py [--iters 20] [--out build/profile]
        [--problem 2d|3d|arm2|xyh|task|gp_inter|arm4|arm5|arm9|arm17|
                   learned|learned3d]
        [--lookup ENGINE]

At one of ``chip_smoke.py``'s B=1024 float32 problems: the 2-D bench problem
(default; T=100, 128x128), the 3-D one (PointRobot3D, 64^3 voxels), the
2-link arm (T=40, self-collision, joint limits), the heading robot (D=6,
nonholonomic), the task-space 3-link arm (workspace goal, LM), the bench
problem with GP interpolation and velocity limits, the 4-link arm (D=8,
T=40), the 5-link arm (D=10, T=40), the 9-link arm (D=18, T=40) or the
17-link arm (D=34, T=40); the learned planner of ``chip_smoke.py`` phase 11
(``learned``: the 2-D bounded-eps feed-forward configuration, GN with
``track_best``; ``learned3d``: PointRobot3D in 32^3 voxels, T=20, LM); a
2-D problem under the lookup engine ``--lookup``
(``ops.sdf.set_lookup_method``, default "auto"; "pallas_v3_1" for
K-LOOKUP-LIMB):

* each layer of one iteration timed alone with CUDA events (median of 20):
  residuals with the lookup, assembly, damping, the solve, and the
  error/freeze bookkeeping; for the learned planner also the encoder (once
  per plan) and the head with the decode;
* ``torch.profiler`` over an ``--iters`` plan: device time by kernel, the
  number of kernel launches per iteration, the device's busy share of the
  wall time, and each of the port's kernels' device µs per launch in the
  loop.  The Chrome trace goes to ``--out``.

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dgpmp2_tpu_torch.core import gn, graph  # noqa: E402
from dgpmp2_tpu_torch.ops import sdf as sdf_ops  # noqa: E402
from dgpmp2_tpu_torch.ops import tridiag  # noqa: E402


def layer_times(bench, reg=0.1):
    spec, robot, params, th0, sdf = bench
    static = graph.assemble_static(spec, params, th0.dtype)
    res = graph.eval_residuals(spec, robot, params, th0, sdf)
    sys_ = graph.assemble_from_residuals(spec, params, res, static=static)
    damped = gn.damped_system(*sys_, torch.tensor(reg, device=th0.device))
    dth = tridiag.btd_solve_auto(*damped)
    err = graph.error_from_residuals(spec, params, res)
    conv = torch.zeros_like(err, dtype=torch.bool)
    cfg = gn.OptimConfig(reg=reg)

    def bookkeeping():
        th_prop = th0 + dth
        take = ~conv
        torch.where(take[:, None, None], th_prop, th0)
        graph.select(take, res, res)
        e = graph.error_from_residuals(spec, params, res).detach()
        torch.where(take, e, err)
        gn._converged(dth, e - err, cfg)
        graph.error_from_residuals(spec, params, res, q_inv=params.q_inv,
                                   obs_inv=params.obs_inv)

    layers = {
        "residuals+lookup": lambda: graph.eval_residuals(spec, robot, params,
                                                         th0, sdf),
        "assembly": lambda: graph.assemble_from_residuals(spec, params, res,
                                                          static=static),
        "damping": lambda: gn.damped_system(*sys_, torch.tensor(
            reg, device=th0.device)),
        "solve (K-BTD)": lambda: tridiag.btd_solve_auto(*damped),
        "errors+freeze": bookkeeping,
    }
    return {k: cs.cuda_ms(fn) for k, fn in layers.items()}


def learned_layer_times(setup):
    """Layer times of one learned GN iteration at the seed (no autograd)."""
    planner, variables, params, th0, sdf, im = setup
    spec, robot = planner.spec, planner.robot
    lm = planner.cfg.method == "lm"
    delta = (torch.full((th0.shape[0],), 1e-4, dtype=th0.dtype,
                        device=th0.device) if lm else
             torch.tensor(planner.cfg.reg, dtype=th0.dtype, device=th0.device))
    stack = planner.stack_inputs(im, sdf)
    feats = planner.conv_features(variables, stack)
    hidden = planner.init_hidden(variables, th0.shape[0])
    covs, _ = planner.predict(variables, th0, feats, hidden)
    p = planner.graph_params(params, covs)
    geom = graph.eval_geometry(spec, robot, th0, sdf)
    res = graph.residuals_from_geometry(spec, robot, p, th0, geom)
    sys_ = graph.assemble_from_residuals(spec, p, res, dtype=th0.dtype)
    damped = gn.damped_system(*sys_, delta, trust_region=lm)

    def errors():
        graph.error_from_residuals(spec, p, res)
        fixed = graph.residuals_from_geometry(spec, robot, params, th0, geom)
        graph.error_from_residuals(spec, params, fixed)

    layers = {
        "encoder (per plan)": lambda: planner.conv_features(variables, stack),
        "head+decode": lambda: planner.graph_params(params, planner.predict(
            variables, th0, feats, hidden)[0]),
        "residuals+lookup": lambda: graph.residuals_from_geometry(
            spec, robot, p, th0, graph.eval_geometry(spec, robot, th0, sdf)),
        "assembly": lambda: graph.assemble_from_residuals(spec, p, res,
                                                          dtype=th0.dtype),
        "damping": lambda: gn.damped_system(*sys_, delta, trust_region=lm),
        "solve (K-BTD)": lambda: tridiag.btd_solve_auto(*damped),
        "errors": errors,
    }
    with torch.no_grad():
        return {k: cs.cuda_ms(fn) for k, fn in layers.items()}


def learned_setup(problem, dev):
    """chip_smoke.py phase 11's 2-D or 3-D learned planner at B=1024."""
    if problem == "learned":
        return cs.learned_setup(dev, *cs.bench_inputs(cs.B))
    occ, start, goal = cs.bench3d_inputs(cs.B, dev, vox=cs.LEARN3D_VOX)
    return cs.learned_setup(dev, occ, start, goal, lkw=cs.LEARN3D,
                            method="lm", t=cs.LEARN3D_T)


# --problem -> the name of a constrained path of chip_smoke.py.
CONSTRAINED = {"arm2": "2-link arm", "xyh": "heading robot",
               "task": "task-space 3-link arm",
               "gp_inter": "GP interpolation + velocity limits",
               "arm4": "4-link arm", "arm5": "5-link arm",
               "arm9": "9-link arm", "arm17": "17-link arm"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--problem", default="2d",
                    choices=["2d", "3d", *CONSTRAINED, "learned",
                             "learned3d"])
    ap.add_argument("--lookup", default="auto")
    args = ap.parse_args()
    sdf_ops.set_lookup_method(args.lookup)
    smi = cs.device_info()
    dev = torch.device("cuda", 0)
    cfg = gn.OptimConfig(reg=0.1, max_iters=args.iters, tol_delta=0.0)
    if args.problem.startswith("learned"):
        setup = learned_setup(args.problem, dev)
        planner, variables, params, th0, sdf, im = setup
        print(f"[{smi}] layer times, ms (median of 20, one layer alone):")
        for k, v in learned_layer_times(setup).items():
            print(f"  {k:18s} {v:.4f}")

        def run():
            with torch.no_grad():
                planner.plan(variables, params, th0, sdf, im,
                             max_iters=args.iters,
                             track_best=args.problem == "learned")

        report(smi, args, *cs.profile_run(run))
        return
    if args.problem in CONSTRAINED:
        planner, *inputs = cs.constrained_problems(
            dev, cs.bench_inputs(cs.B))[CONSTRAINED[args.problem]]
        bench = cs.problem_of(planner, *inputs)
        cfg = dataclasses.replace(planner.cfg, max_iters=args.iters,
                                  tol_delta=0.0)
    else:
        inputs = (cs.bench3d_inputs(cs.B, dev) if args.problem == "3d"
                  else cs.bench_inputs(cs.B))
        bench = cs.port_problem(*inputs, dev, torch.float32)

    print(f"[{smi}] layer times, ms (median of 20, one layer alone):")
    for k, v in layer_times(bench).items():
        print(f"  {k:18s} {v:.4f}")

    report(smi, args, *cs.profile_plan(bench, cfg))


def report(smi, args, prof, rec):
    """Print the profiled plan's record and kernel table; write its trace."""
    print(f"[{smi}] profiled plan of {args.iters} iterations (lookup engine "
          f"{args.lookup}): wall "
          f"{rec['wall_ms']:.3f} ms, device busy {rec['busy_ms']:.3f} ms "
          f"({rec['busy_ms'] / rec['wall_ms']:.3f} of wall), {rec['ops']} "
          f"device operations ({rec['ops'] / args.iters:.1f} per iteration)")
    for label, name in (("K-BTD", "btd_solve"), ("K-LOOKUP", "sdf_lookup"),
                        ("K-LOOKUP3D", "sdf_lookup3d"),
                        ("K-LOOKUP-LIMB", "sdf_lookup_limbs")):
        if name in rec:
            k = rec[name]
            print(f"[{smi}] {label}: {k['launches']} launches, {k['us']:.2f} "
                  f"µs device time per launch, {k['share']:.3f} of device "
                  f"time")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        args.out, f"plan_{args.problem}_{args.lookup}_trace.json"))


if __name__ == "__main__":
    main()
