#!/usr/bin/env python
"""Serving latency and throughput of the PyTorch port under concurrent load.

The port's counterpart of ``benchmarks/bench_serve.py``, with its flags and
defaults, plus ``--device``.  Drives ``dgpmp2_tpu_torch.serve.
PlanningService`` as a deployment would: many independent clients
``submit()`` one planning problem each (a closed loop: each round's clients
wait for their replies), and the dispatcher coalesces them into batches of
the service's width.  For each offered concurrency level it prints the
plans per second and the client-observed p50/p99 latency (queue wait,
coalescing window and the dispatch), with the device they ran on: the
card's name and power limit (``nvidia-smi``) on a GPU.  A level of fewer
than 100 responses gives its largest latency in place of a p99 (raise
``--rounds`` for a tail).

Concurrency 1 pays a whole dispatch per plan; concurrency at the batch
width fills every dispatch.

Usage: python tools/bench_serve_torch.py [--batch 256] [--t 100]
       [--iters 50] [--window_ms 5] [--levels 1 8 64 256] [--rounds 3]
       [--inline_sdf] [--multistart K [--prune_iters N --keep M]
       [--rrt_seeds E --rrt_plan_time S]] [--device cuda]
"""
from __future__ import annotations

import argparse
import asyncio
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dgpmp2_tpu_torch.ops import sdf as sdf_ops  # noqa: E402
from dgpmp2_tpu_torch.serve import PlanningService, PlanRequest  # noqa: E402
from dgpmp2_tpu_torch.utils.config import CONFIG_DIR as CFG  # noqa: E402

IMSIZE = 128
# The campaigns' fixed covariances (tools/learned_campaign.py COV).
COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
           k_g=0.01)
# The fewest latencies a p99 is stated on: below it the 99th percentile is
# the largest sample, and a row gives that maximum instead.
P99_MIN_N = 100


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them on a
    GPU; on the CPU, the word CPU (no device metric is measured there)."""
    if torch.device(device).type != "cuda":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def make_planner(t, max_iters, device, yaml="2d"):
    """The ``gpmp2_<yaml>_params.yaml`` DiffGPMP2Planner at T=t with
    ``max_iters`` GN iterations, float32, on ``device``."""
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot
    from dgpmp2_tpu_torch.utils.config import load_params

    env, pp, gp, obs, opt, robot_data = load_params(
        os.path.join(CFG, f"gpmp2_{yaml}_params.yaml"),
        os.path.join(CFG, f"robot_{yaml}.yaml"),
        os.path.join(CFG, f"env_{yaml}_params.yaml"))
    lims = {k: env[k] for k in ("x_lims", "y_lims", "z_lims") if k in env}
    return DiffGPMP2Planner(
        gp, obs, dict(pp, total_time_step=t), dict(opt, max_iters=max_iters),
        lims, make_robot(robot_data), dtype=torch.float32, device=device)


def make_world(device) -> np.ndarray:
    """``benchmarks/bench_serve.py``'s world: a 30×30-pixel obstacle in a
    128² image, its SDF built on ``device``, as float32 numpy."""
    img = np.ones((IMSIZE, IMSIZE), np.float32)
    img[40:70, 50:80] = 0.0
    sdf = sdf_ops.sdf_from_occupancy(torch.tensor(img, device=device),
                                     res=10.0 / IMSIZE, dtype=torch.float32)
    return sdf.cpu().numpy()


def make_requests(world, n, seed, inline_sdf=False):
    """n requests from near (-4, -4) to near (4, 4) in ``world``: inline, or
    by its registered name "bench"."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        s = np.array([-4.0, -4.0, 0.0, 0.0], np.float32)
        g = np.array([4.0, 4.0, 0.0, 0.0], np.float32)
        s[:2] += rng.uniform(-0.5, 0.5, 2)
        g[:2] += rng.uniform(-0.5, 0.5, 2)
        if inline_sdf:
            reqs.append(PlanRequest(start=s, goal=g, sdf=world))
        else:
            reqs.append(PlanRequest(start=s, goal=g, world="bench"))
    return reqs


async def run_requests(svc, batches):
    """Submit each list of ``batches`` concurrently, one list after the
    other: (wall s, the responses in order)."""
    out = []
    t0 = time.perf_counter()
    for reqs in batches:
        out += await asyncio.gather(*(svc.submit(q) for q in reqs))
    return time.perf_counter() - t0, out


def level_row(concurrency, wall, responses) -> dict:
    """Plans per second, the p50 and largest latency (ms) of one level's
    responses, and the p99 as ``benchmarks/bench_serve.py`` computes it
    where there are at least ``P99_MIN_N`` of them (else None)."""
    if not all(np.isfinite(r.err_final) for r in responses):
        raise RuntimeError("non-finite plan in serving bench")
    lat = np.sort([r.latency_s for r in responses])
    n = len(lat)
    return {"concurrency": concurrency, "n": n, "plans_per_s": n / wall,
            "p50_ms": float(lat[n // 2] * 1e3),
            "p99_ms": (float(lat[int(n * 0.99)] * 1e3) if n >= P99_MIN_N
                       else None),
            "max_ms": float(lat[-1] * 1e3)}


async def run_level(svc, world, concurrency, rounds, seed, inline_sdf=False):
    """``rounds`` rounds of ``concurrency`` concurrent clients: (the level's
    row, its responses)."""
    wall, responses = await run_requests(svc, [
        make_requests(world, concurrency, seed + r, inline_sdf)
        for r in range(rounds)])
    return level_row(concurrency, wall, responses), responses


def row_line(label, row) -> str:
    p99 = (f"p99 {row['p99_ms']:7.1f} ms" if row["p99_ms"] is not None
           else f"p99 n/a (n < {P99_MIN_N}), max {row['max_ms']:7.1f} ms")
    return (f"[{label}] concurrency {row['concurrency']:5d}: "
            f"{row['plans_per_s']:10.1f} plans/s  p50 {row['p50_ms']:7.1f} "
            f"ms  {p99}  (n={row['n']})")


def make_multistart_adapter(t, iters, restarts, device, prune_iters=0,
                            keep=0, rrt_seeds=0, rrt_plan_time=0.05,
                            rrt_max_iters=20000):
    """``benchmarks/bench_serve.py``'s multistart serving path: the
    ``MultistartPlanningAdapter`` over the 2-D point robot with the
    campaigns' covariances, LM, amplitude 2.0, optionally RRT*-seeded
    (the native planner on the host before each dispatch)."""
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.robots import PointRobot2D
    from dgpmp2_tpu_torch.serve import MultistartPlanningAdapter

    return MultistartPlanningAdapter(
        graph.GraphSpec(total_time_step=t), PointRobot2D(), COV,
        optim_cfg=gn.OptimConfig(reg=0.1, max_iters=iters, method="lm"),
        restarts=restarts, amp=2.0, prune_iters=prune_iters, keep=keep,
        rrt_seeds=rrt_seeds, rrt_plan_time=rrt_plan_time,
        rrt_max_iters=rrt_max_iters, device=device)


async def amain(args):
    device = torch.device(args.device)
    label = device_label(device)
    if args.multistart:
        planner = make_multistart_adapter(
            args.t, args.iters, args.multistart, device, args.prune_iters,
            args.keep, args.rrt_seeds, args.rrt_plan_time)
    else:
        planner = make_planner(args.t, args.iters, device)
    svc = PlanningService(planner, batch_size=args.batch,
                          window_ms=args.window_ms)
    world = make_world(device)
    print(f"warm-up: batch={args.batch} T={args.t} iters={args.iters} "
          f"on {label} ...", flush=True)
    t0 = time.perf_counter()
    svc.warmup(world.shape)
    print(f"warm-up (kernel build and launch plans) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    svc.register_world("bench", world)
    await svc.start()
    try:
        # One pass through the dispatch path first.
        await run_level(svc, world, min(8, args.batch), 1, 999,
                        args.inline_sdf)
        for level in args.levels:
            row, _ = await run_level(svc, world, level, args.rounds, 42,
                                     args.inline_sdf)
            print(row_line(label, row), flush=True)
    finally:
        await svc.stop()
    print({"batches": svc.stats["batches"],
           "padded_rows": svc.stats["padded_rows"],
           "requests": svc.stats["requests"]})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--t", type=int, default=100)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--window_ms", type=float, default=5.0)
    p.add_argument("--levels", nargs="+", type=int,
                   default=[1, 8, 64, 256])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--inline_sdf", action="store_true",
                   help="ship the SDF with every request instead of the "
                        "device-resident world bank (measures the "
                        "per-request upload)")
    p.add_argument("--multistart", type=int, default=0, metavar="K",
                   help="serve through MultistartPlanningAdapter with K "
                        "restarts instead of the straight-seed planner")
    p.add_argument("--prune_iters", type=int, default=0)
    p.add_argument("--keep", type=int, default=0)
    p.add_argument("--rrt_seeds", type=int, default=0,
                   help="host RRT* seeds appended per problem (requires "
                        "--multistart)")
    p.add_argument("--rrt_plan_time", type=float, default=0.05,
                   help="per-problem RRT* budget (s, host wall clock; "
                        "sequential over the dispatch batch)")
    p.add_argument("--device", default="cuda",
                   help="the planner's device (cuda, or cpu to rehearse)")
    args = p.parse_args(argv)
    if args.rrt_seeds and not args.multistart:
        p.error("--rrt_seeds requires --multistart")
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
