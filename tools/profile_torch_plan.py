#!/usr/bin/env python3
"""Where the time of one GN iteration of the PyTorch port goes, on a GPU.

    python3 tools/profile_torch_plan.py [--iters 20] [--out build/profile]
        [--problem 2d|3d|arm2|xyh|task|gp_inter|arm4]

At one of ``chip_smoke.py``'s B=1024 float32 problems: the 2-D bench problem
(default; T=100, 128x128), the 3-D one (PointRobot3D, 64^3 voxels), the
2-link arm (T=40, self-collision, joint limits), the heading robot (D=6,
nonholonomic), the task-space 3-link arm (workspace goal, LM), the bench
problem with GP interpolation and velocity limits, or the 4-link arm (D=8,
T=40):

* each layer of one iteration timed alone with CUDA events (median of 20):
  residuals with the lookup, assembly, damping, the solve, and the
  error/freeze bookkeeping;
* ``torch.profiler`` over an ``--iters`` plan: device time by kernel, the
  number of kernel launches per iteration, and the device's busy share of
  the wall time.  The Chrome trace goes to ``--out``.

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dgpmp2_tpu_torch.core import gn, graph  # noqa: E402
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


# --problem -> the name of a constrained path of chip_smoke.py.
CONSTRAINED = {"arm2": "2-link arm", "xyh": "heading robot",
               "task": "task-space 3-link arm",
               "gp_inter": "GP interpolation + velocity limits",
               "arm4": "4-link arm"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--problem", default="2d",
                    choices=["2d", "3d", *CONSTRAINED])
    args = ap.parse_args()
    smi = cs.device_info()
    dev = torch.device("cuda", 0)
    cfg = gn.OptimConfig(reg=0.1, max_iters=args.iters, tol_delta=0.0)
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
    spec, robot, params, th0, sdf = bench

    print(f"[{smi}] layer times, ms (median of 20, one layer alone):")
    for k, v in layer_times(bench).items():
        print(f"  {k:18s} {v:.4f}")

    gn.plan(spec, robot, params, th0, sdf, cfg)  # warm-up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gn.plan(spec, robot, params, th0, sdf, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernel rows only: an op's row repeats the device time of its kernels.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    print(f"[{smi}] profiled plan of {args.iters} iterations: wall "
          f"{wall_ms:.3f} ms, device busy {dev_us / 1e3:.3f} ms "
          f"({dev_us / 1e3 / wall_ms:.3f} of wall), {n_kernels} device "
          f"operations ({n_kernels / args.iters:.1f} per iteration)")
    btd = [e for e in kernels if "btd_solve_kernel" in e.key]
    btd_us = sum(e.self_device_time_total for e in btd)
    btd_n = sum(e.count for e in btd)
    print(f"[{smi}] K-BTD: {btd_n} launches, {btd_us / 1e3 / max(btd_n, 1):.4f}"
          f" ms per launch, {btd_us / max(dev_us, 1e-9):.3f} of device time")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"plan_{args.problem}_trace.json"))


if __name__ == "__main__":
    main()
