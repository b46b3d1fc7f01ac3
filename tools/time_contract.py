#!/usr/bin/env python3
"""Broadcast sum against batched matrix product in the assembly, on a GPU.

    python3 tools/time_contract.py [--problems 2d,3d,arm2,...]

At ``chip_smoke.py``'s B=1024 float32 problems (the names of
``tools/profile_torch_plan.py --problem``; default all but the learned
ones, whose point robots contract as ``2d`` does), every contraction of one
``graph.assemble_from_residuals`` (``graph._contract``: a unary factor's
Σ over K of a broadcast product) is timed in both forms, the broadcast
product summed over one axis and the batched matrix product, with CUDA
events (median of 20), beside the broadcast product's element count; then
the whole assembly with ``graph.BROADCAST_MAX`` at 0 (every contraction a
matrix product), at its default and unbounded (every one broadcast).  A
form that does not fit in the card's memory prints "out of memory".

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dgpmp2_tpu_torch.core import graph  # noqa: E402
from profile_torch_plan import CONSTRAINED  # noqa: E402

PROBLEMS = ["2d", "3d", *CONSTRAINED]


def timed(fn):
    """CUDA-event ms of ``fn``, or None where it runs out of memory."""
    try:
        return cs.cuda_ms(fn)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def show(ms):
    return "out of memory" if ms is None else f"{ms:.4f}"


def contractions(spec, params, res):
    """The arguments of every ``graph._contract`` of one assembly."""
    calls, inner = [], graph._contract

    def spy(*args):
        calls.append(args)
        return inner(*args)

    graph._contract = spy
    try:
        graph.assemble_from_residuals(spec, params, res)
    finally:
        graph._contract = inner
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", default=",".join(PROBLEMS))
    args = ap.parse_args()
    smi = cs.device_info()
    dev = torch.device("cuda", 0)
    bench_np = cs.bench_inputs(cs.B)
    names = args.problems.split(",")
    constrained = (cs.constrained_problems(dev, bench_np)
                   if any(n in CONSTRAINED for n in names) else {})
    default = graph.BROADCAST_MAX
    print(f"[{smi}] B={cs.B} float32, ms (median of 20 CUDA-event runs); "
          f"BROADCAST_MAX = 2^{default.bit_length() - 1}")
    for name in names:
        if name in CONSTRAINED:
            bench = cs.problem_of(*constrained[CONSTRAINED[name]])
        else:
            bench = cs.port_problem(*(cs.bench3d_inputs(cs.B, dev)
                                      if name == "3d" else bench_np),
                                    dev, torch.float32)
        spec, robot, params, th0, sdf = bench
        with torch.no_grad():
            res = graph.eval_residuals(spec, robot, params, th0, sdf)
            for i, (x, y, dim, mm, a, b) in enumerate(
                    contractions(spec, params, res)):
                n = torch.broadcast_shapes(x.shape, y.shape).numel()
                ms_b = timed(lambda: torch.sum(x * y, dim=dim))
                ms_m = timed(lambda: mm(a, b))
                print(f"[{smi}] {name} contraction {i}: {n} elements "
                      f"({n / default:.3f} x BROADCAST_MAX), shape "
                      f"{tuple(torch.broadcast_shapes(x.shape, y.shape))}: "
                      f"broadcast {show(ms_b)}, matmul {show(ms_m)}")
            whole = {}
            for label, cap in (("matmul", 0), ("default", default),
                               ("broadcast", 1 << 62)):
                graph.BROADCAST_MAX = cap
                try:
                    whole[label] = timed(lambda: graph.assemble_from_residuals(
                        spec, params, res))
                finally:
                    graph.BROADCAST_MAX = default
        print(f"[{smi}] {name} assembly: every contraction matmul "
              f"{show(whole['matmul'])}, default {show(whole['default'])}, "
              f"every contraction broadcast {show(whole['broadcast'])}")
        del bench, res
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
