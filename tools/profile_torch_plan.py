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
K-LOOKUP-LIMB), ``torch.profiler`` over an ``--iters`` plan:

* each of the plan's spans (``utils.profiling``: residuals, assembly,
  solve, errors, update; the learned planner's encoder and head): the
  kernels launched inside it and their device ms, per iteration, and the
  stages' share of the plan's device time;
* host µs per launch inside ``dgpmp2.plan``, and the device's idle share
  between the plan's first and last operation;
* device time by kernel, the number of kernel launches per iteration, the
  device's busy share of the wall time, and each of the port's kernels'
  device µs per launch in the loop.  The Chrome trace goes to ``--out``.

The stage table profiles the eager loop (``chip_smoke.profile_run``).  A
plan of ``core.gn.plan`` is then run twice (eagerly, then captured) and one
replay of its CUDA graph profiled: its device ms and kernel launches a
call, and its wall ms, beside the eager loop's (not for the learned plan,
whose loop is not captured).

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dgpmp2_tpu_torch.core import gn  # noqa: E402
from dgpmp2_tpu_torch.ops import sdf as sdf_ops  # noqa: E402
from portbench.trace import COPIES, union_us  # noqa: E402


def spans(events) -> dict:
    """Each ``dgpmp2.*`` span of a profiled run: its instances, host µs,
    and the kernels launched inside it (a device operation is put to the
    span whose host interval holds its runtime call, whose id it shares),
    their count and device µs; ``dgpmp2.plan`` also the device µs from
    each instance's first operation to its last and the idle µs there."""
    from torch.autograd import DeviceType

    host, launched, ops = {}, {}, []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            ops.append((e.id, t0, t1, e.name))
        elif e.name.startswith("dgpmp2."):
            host.setdefault(e.name, []).append((t0, t1))
        elif e.name.startswith("cu"):
            launched[e.id] = t0
    out = {}
    for name, inst in host.items():
        inst.sort()
        starts = [t0 for t0, _ in inst]
        rec = {"count": len(inst), "host_us": sum(t1 - t0 for t0, t1 in inst),
               "launches": 0, "device_us": 0.0}
        members = [[] for _ in inst]
        for oid, t0, t1, op in ops:
            at = launched.get(oid)
            i = -1 if at is None else bisect.bisect_right(starts, at) - 1
            if i < 0 or inst[i][1] < at:
                continue
            members[i].append((t0, t1))
            if not op.startswith(COPIES):
                rec["launches"] += 1
                rec["device_us"] += t1 - t0
        if name == "dgpmp2.plan":
            hulls = [(min(m)[0], max(t1 for _, t1 in m), union_us(m))
                     for m in members if m]
            rec["interval_us"] = sum(hi - lo for lo, hi, _ in hulls)
            rec["idle_us"] = sum(hi - lo - busy for lo, hi, busy in hulls)
        out[name] = rec
    return out


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
        planner, variables, params, th0, sdf, im = learned_setup(
            args.problem, dev)

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
    prof, eager = cs.profile_plan(bench, cfg)
    report(smi, args, prof, eager)
    gn.plan(*bench, cfg)  # the key's first plan, eager; the next captures
    prof_r, replay = cs.profile_run(lambda: gn.plan(*bench, cfg),
                                    eager=False)
    print(f"[{smi}] a call of {args.iters} iterations, replayed / eager: "
          f"device {replay['busy_ms']:.3f} / {eager['busy_ms']:.3f} ms, "
          f"{launches(prof_r)} / {launches(prof)} kernel launches, wall "
          f"{replay['wall_ms']:.3f} / {eager['wall_ms']:.3f} ms")


def launches(prof) -> int:
    """Kernels the device ran in a profile (copies and fills left out)."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(COPIES))


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
    table, n = spans(prof.events()), args.iters
    print(f"[{smi}] spans: instances, launches and device ms per iteration")
    for name, r in sorted(table.items()):
        print(f"  {name:18s} {r['count']:5d} {r['launches'] / n:8.2f} "
              f"{r['device_us'] / 1e3 / n:9.4f}")
    plan = table.get("dgpmp2.plan")
    if plan and plan["launches"]:
        stages = sum(r["device_us"] for k, r in table.items()
                     if k != "dgpmp2.plan")
        print(f"[{smi}] stages {stages / plan['device_us']:.4f} of the "
              f"plan's device time; {plan['host_us'] / plan['launches']:.2f} "
              f"host µs per launch; device idle "
              f"{plan['idle_us'] / plan['interval_us']:.4f} of the plan's "
              f"device interval")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        args.out, f"plan_{args.problem}_{args.lookup}_trace.json"))


if __name__ == "__main__":
    main()
