#!/usr/bin/env python3
"""Device-only times of the port's four CUDA kernels at the main paths'
shapes and access patterns, on a GPU, for one checkout's kernels, so that
an earlier commit and this one can be timed in turns in one run.

    python3 tools/time_kernels.py [--repo DIR] [--label NAME] [--gn]
        [--btd | --btd-digest | --stream | --stream-digest]
        [--out build/time_kernels]

The kernels come from the ``dgpmp2_tpu_torch`` package under ``--repo``
(default: this checkout; for an earlier commit, unpack it with ``git
archive <rev> dgpmp2_tpu_torch | tar -x -C DIR``).  Problems and timing
helpers come from this checkout's ``chip_smoke.py``: each lookup is timed
on the lookup a path makes (``chip_smoke.path_lookups``), K-BTD at
``chip_smoke.BTD_TIMED``, ``BTD_WIDE_TIMED`` (D = 18, 32; skipped by a
tree whose K-BTD refuses them) and ``BTD_BLOCK_TIMED`` (D = 33, 34, 64), K-LOOKUP-LIMB at L = 1, 2, 3 on the 2-D
paths' lookups ``chip_smoke.LIMB_SHAPES`` with the time of the tree's
split of the SDF (the packed limbs, or in a tree from before them the
(B, L, H, W) limb planes); each record holds ``chip_smoke.kernel_ms``'s
times (device-only, CUDA graph, host-inclusive events, host µs per
``launch()``), the host µs per ``ops.sdf.lookup_nd`` call for the lookups
(under the limb engine of its L for K-LOOKUP-LIMB), and the bound.
``--btd`` times K-BTD alone, also on the 9- and 17-link arms' own
first-iteration systems (``chip_smoke.BTD_ARMS``, ``first_system``);
``--btd-digest`` times nothing and writes the
sha256 of K-BTD's output on each of ``chip_smoke.py`` phase 3's systems
(``chip_smoke.btd_digests``), so that two trees' K-BTD can be held
bit-equal.  ``--stream`` times K-STREAM alone: its three instances on the
first GN step of the 2-D and 3-D benches and of the 4-, 9- and 17-link
arms (``chip_smoke.stream_args``; D = 4, 6, 8, 18, 34), at the 2-D bench
also with the lane-group kernel's producer warps capped at 1, 3 and 7
(``ops.cuda.btd_stream.set_producers``, where the tree has it), at the 9-
and 17-link arms (the wide and block kernels) also under each restriction
of :data:`ROWS_CHOICES` (``btd_stream.set_rows_plan``, where the tree has
it), each with its bound and launch plan, and the standard engine's step
at each path (``chip_smoke.standard_step_times``).  ``--stream-digest``
times nothing and writes the sha256 of K-STREAM's x on each of
``chip_smoke.py`` phase 19 (a)'s
systems, GN and LM, in the three instances (``chip_smoke.stream_digests``).
``--gn`` adds ms per GN iteration of the 2-D (also under ``pallas_v3_1``),
3-D, 2- and 4-link arm and heading-robot plans (``chip_smoke.plan_ms``)
and a profiled 20-iteration plan of each (``chip_smoke.profile_plan``).  Prints one line per record with the
card's name and power limit and writes ``time_kernels_<label>.json`` under
``--out``.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def timed(cs, smi, records, rec, launch, kernel, entry=None, **timing):
    cs.kernel_ms(rec, launch, None, kernel, **timing)
    if entry is not None:
        rec["entry_host_us"] = cs.host_us(entry)
    records.append(rec)
    print(f"[{smi}] {kernel} {rec['shape']} "
          f"{json.dumps({k: v for k, v in rec.items() if k != 'shape'})}",
          flush=True)


# K-LOOKUP-LIMB's engine of each L.
LIMB_ENGINES = {1: "pallas_v3_1", 2: "pallas_v3_2", 3: "pallas_v3"}


def time_limbs(cs, smi, records, lookups):
    """K-LOOKUP-LIMB at L = 1, 2, 3 on ``chip_smoke.LIMB_SHAPES``."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs

    split = getattr(sdf_lookup_limbs, "split", sdf_ops.limb_split)
    for name in cs.LIMB_SHAPES:
        sdf, pts, res, xl, yl = lookups[name]
        b, p = pts.shape[:2]
        for n in (1, 2, 3):
            limbs = split(sdf, n)
            rec = {"shape": f"L={n} {name}", "B": b, "P": p, "L": n,
                   "split_ms": cs.cuda_ms(lambda n=n: split(sdf, n), reps=10),
                   **cs.lookup_bound(b * p, 2, 4, 2 * n, torch.float32)}
            sdf_ops.set_lookup_method(LIMB_ENGINES[n])
            try:
                timed(cs, smi, records, rec,
                      lambda a=(limbs, pts, res, xl, yl):
                      sdf_lookup_limbs.launch(*a),
                      "sdf_lookup_limbs_kernel",
                      lambda a=(sdf, pts, res, xl, yl): sdf_ops.lookup_nd(*a))
            finally:
                sdf_ops.set_lookup_method("auto")
            del limbs


def time_kernels(cs, dev, smi, btd_only=False):
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import btd_solve, sdf_lookup, sdf_lookup3d

    records = []
    lookups = {} if btd_only else cs.path_lookups(dev)
    for name, args in lookups.items():
        sdf, points = args[:2]
        ndim = points.shape[-1]
        k, kernel = ((sdf_lookup, "sdf_lookup_kernel") if ndim == 2
                     else (sdf_lookup3d, "sdf_lookup3d_kernel"))
        rec = {"shape": name, "B": points.shape[0], "P": points.shape[1],
               "dtype": str(sdf.dtype), "grid": list(sdf.shape[1:]),
               **cs.lookup_bound(points.shape[0] * points.shape[1], ndim,
                                 2 ** ndim, sdf.element_size(), sdf.dtype)}
        timed(cs, smi, records, rec,
              lambda k=k, args=args: k.launch(*args, "intended"), kernel,
              lambda args=args: sdf_ops.lookup_nd(*args))
    if not btd_only:
        time_limbs(cs, smi, records, lookups)
    del lookups
    rng = np.random.default_rng(1)
    systems = [(label, dtype, lambda b=b, t=t, d=d, dtype=dtype:
                cs.spd_system(rng, b, t, d, dtype, dev))
               for label, b, t, d, dtype in
               cs.BTD_TIMED + cs.BTD_WIDE_TIMED + cs.BTD_BLOCK_TIMED]
    if btd_only:
        problems = cs.constrained_problems(dev, cs.bench_inputs(cs.B))
        systems += [(f"{name}'s first-iteration system", torch.float32,
                     lambda name=name: cs.first_system(
                         cs.problem_of(*problems[name])))
                    for name in cs.BTD_ARMS]
    for label, dtype, make in systems:
        diag, off, rhs = make()
        b, t, d = rhs.shape
        try:
            btd_solve.launch(diag, off, rhs)
        except ValueError as e:
            print(f"K-BTD {label} D={d}: not taken by this tree ({e})")
            continue
        bound_ms, bound_by = cs.btd_bound(b, t, d, dtype)
        rec = {"shape": label, "B": b, "T": t, "D": d, "dtype": str(dtype),
               "bound_ms": bound_ms, "bound_by": bound_by}
        timed(cs, smi, records, rec,
              lambda a=(diag, off, rhs): btd_solve.launch(*a),
              "btd_solve_kernel", **(cs.ARM_TIMING if d > 16 else {}))
        del diag, off, rhs
    return records


# K-STREAM's producer-warp caps timed at the 2-D bench.
PRODUCER_CAPS = (1, 3, 7)
# The wide and block kernels' plan restrictions timed at the 9- and
# 17-link arms ({}: the plan's own choice).
ROWS_CHOICES = ({}, {"formers": 1}, {"formers": 2}, {"formers": 3},
                {"formers": 4}, {"stages": 2}, {"stages": 3}, {"stages": 4},
                {"chunk_rows": 16}, {"chunk_rows": 32}, {"chunk_rows": 64},
                {"keep": False})


def time_stream(cs, dev, smi):
    """K-STREAM at the 2-D and 3-D benches and the arms of
    ``chip_smoke.STREAM_TIMED_ARMS``, three instances each (the arms with
    ``chip_smoke.ARM_TIMING``'s counts)."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    bench_np = cs.bench_inputs(cs.B)
    constrained = cs.constrained_problems(dev, bench_np)
    problems = {
        "2-D bench": lambda: cs.port_problem(*bench_np, dev, torch.float32),
        "3-D bench": lambda: cs.port_problem(*cs.bench3d_inputs(cs.B, dev),
                                             dev, torch.float32),
        **{name: lambda name=name: cs.problem_of(*constrained[name])
           for name in cs.STREAM_TIMED_ARMS}}
    records = []
    for label, make in problems.items():
        problem = make()
        spec = problem[0]
        timing = {} if "bench" in label else cs.ARM_TIMING
        d = spec.state_dim
        caps = (PRODUCER_CAPS if label == "2-D bench"
                and hasattr(k, "set_producers") else (None,))
        rows = (ROWS_CHOICES if d > 16 and hasattr(k, "set_rows_plan")
                else ({},))
        for inst in cs.STREAM_INSTANCES:
            a, kw = cs.stream_args(problem, inst)
            x = k.launch(*a, **kw)
            bound_ms, bound_by = cs.stream_bound(a, kw, x)
            kind = k.KINDS[(a[0].dtype, a[6].dtype)]
            for cap in caps:
                for choice in rows:
                    rec = {"shape": f"{label} {inst}", "B": x.shape[0],
                           "T1": spec.num_traj_states, "D": d,
                           "instance": inst, "bound_ms": bound_ms,
                           "bound_by": bound_by}
                    if cap is not None:
                        k.set_producers(cap)
                        rec["producer_cap"] = cap
                    if choice:
                        k.set_rows_plan(**choice)
                        rec["rows_choice"] = choice
                    try:
                        if d <= 16 and hasattr(k, "geometry"):
                            rec["plan"] = k.geometry(d, x.shape[0], kind)
                        elif hasattr(k, "set_rows_plan"):
                            rec["plan"] = k.geometry(
                                d, x.shape[0], kind,
                                families=k.family_shapes(a[9], x.shape[0],
                                                         x.shape[1]))
                        timed(cs, smi, records, rec,
                              lambda: k.launch(*a, **kw),
                              "btd_stream_kernel", **timing)
                    except ValueError as e:  # no plan under this choice
                        print(f"{label} {inst} {choice}: {e}")
                    finally:
                        if cap is not None:
                            k.set_producers(0)
                        if choice:
                            k.set_rows_plan()
            del a, kw, x
        if hasattr(cs, "standard_step_times"):
            rec = {"shape": f"{label} standard engine's step (float32)",
                   **cs.standard_step_times(problem, timing)}
            records.append(rec)
            print(f"[{smi}] {json.dumps(rec)}", flush=True)
        del problem
        torch.cuda.empty_cache()
    return records


def time_gn(cs, dev, smi):
    """ms per GN iteration of six paths (``chip_smoke.plan_ms``), and a
    profiled 20-iteration plan of each (``chip_smoke.profile_plan``)."""
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    bench_np = cs.bench_inputs(cs.B)
    constrained = cs.constrained_problems(dev, bench_np)
    bench2d = lambda: cs.port_problem(*bench_np, dev, torch.float32)  # noqa: E731
    # key -> (problem, 2-D lookup engine)
    problems = {
        "": (bench2d, "auto"),
        "_v3_1": (bench2d, "pallas_v3_1"),
        "_3d": (lambda: cs.port_problem(*cs.bench3d_inputs(cs.B, dev), dev,
                                        torch.float32), "auto"),
        "_arm2": (lambda: cs.problem_of(*constrained["2-link arm"]), "auto"),
        "_xyh": (lambda: cs.problem_of(*constrained["heading robot"]),
                 "auto"),
        "_arm4": (lambda: cs.problem_of(*constrained["4-link arm"]), "auto"),
    }
    cfg = gn.OptimConfig(reg=0.1, max_iters=20, tol_delta=0.0)
    out, prof = {}, {}
    for key, (make, engine) in problems.items():
        bench = make()
        sdf_ops.set_lookup_method(engine)
        try:
            t50, t200, out[key] = cs.plan_ms(bench)
            prof[key] = cs.profile_plan(bench, cfg)[1]
        finally:
            sdf_ops.set_lookup_method("auto")
        print(f"[{smi}] gn_iter_ms_b1024{key} {out[key]:.4f} (50 iterations "
              f"{t50:.3f} ms, 200 iterations {t200:.3f} ms); profiled 20 "
              f"iterations {json.dumps(prof[key])}", flush=True)
        del bench
    return out, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--label", default="change")
    ap.add_argument("--gn", action="store_true")
    ap.add_argument("--btd", action="store_true")
    ap.add_argument("--btd-digest", action="store_true",
                    help="only K-BTD's output digests on phase 3's systems")
    ap.add_argument("--stream", action="store_true",
                    help="only K-STREAM, at the benches and the arms")
    ap.add_argument("--stream-digest", action="store_true",
                    help="only K-STREAM's output digests on phase 19's "
                         "systems")
    ap.add_argument("--out", default=str(ROOT / "build" / "time_kernels"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    cs = load_chip_smoke()
    smi = cs.device_info()
    dev = torch.device("cuda", 0)
    from dgpmp2_tpu_torch.ops.cuda import _build

    print(f"kernels from {Path(_build.__file__).resolve().parents[2]}")
    _build.library()
    result = {"label": args.label, "card": smi}
    if args.btd_digest:
        result["btd_digests"] = cs.btd_digests(dev)
        print(f"{len(result['btd_digests'])} K-BTD outputs digested")
    elif args.stream_digest:
        result["stream_digests"] = cs.stream_digests(dev)
        print(f"{len(result['stream_digests'])} K-STREAM outputs digested")
    elif args.stream:
        result["kernels"] = time_stream(cs, dev, smi)
    else:
        result["kernels"] = time_kernels(cs, dev, smi, args.btd)
    if args.gn:
        result["gn_iter_ms"], result["gn_profile"] = time_gn(cs, dev, smi)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"time_kernels_{args.label}.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
