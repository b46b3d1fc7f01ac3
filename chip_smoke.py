#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dgpmp2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build both CUDA kernels from ``dgpmp2_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B=1024 problems, T=100, 128x128 SDFs);
4. float64 kernels on the small golden that the JAX package wrote
   (``tests/goldens/torch_port_plan_small.npz``);
5. the main path: the bench.py problem at B=1024 in float32 through
   ``DiffGPMP2Planner.plan`` (YAML configs) and ``core.gn.plan``, with the
   kernels' launch counters zeroed before and read after;
6. timing with CUDA events: ms per GN iteration and each kernel beside its
   plain version.

The last two lines are JSON: the kernels' record, then the device record.
Imports no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "torch_port_plan_small.npz"
CONFIGS = ROOT / "dgpmp2_tpu" / "configs"
B, T, IMSIZE = 1024, 100, 128
LIMS = (-5.0, 5.0)


def phase(name):
    print(f"== {name}", flush=True)


def device_info() -> str:
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    return smi


def build():
    phase("2 build")
    from dgpmp2_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")
    print(_build.build_log)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` runs, timed by CUDA
    events around each run after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def bench_inputs(b: int, seed: int = 0):
    """bench.py:44-68's numpy construction: one 20x20 obstacle per image,
    starts near (-4, -4) and goals near (4, 4)."""
    rng = np.random.default_rng(seed)
    imgs = np.ones((b, IMSIZE, IMSIZE), np.uint8)
    for i in range(b):
        r, c = rng.integers(20, 90, 2)
        imgs[i, r:r + 20, c:c + 20] = 0
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    return imgs, start, goal


def port_problem(imgs, start, goal, dev, dtype, t=T, cost_sigma=0.05,
                 epsilon_dist=0.4, k_s=0.01, k_g=0.01):
    """The bench problem in the port: SDFs built on ``dev`` by the port's
    exact EDT, fixed-covariance params and straight-line seeds."""
    from dgpmp2_tpu_torch.core import graph
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.robots import PointRobot2D
    from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

    spec = graph.GraphSpec(total_time_step=t)
    robot = PointRobot2D()
    sdf = sdf_ops.sdf_from_occupancy(torch.tensor(imgs, device=dev),
                                     res=10.0 / imgs.shape[-1], dtype=dtype)
    start_t = torch.tensor(start, dtype=dtype, device=dev)
    goal_t = torch.tensor(goal, dtype=dtype, device=dev)
    params = graph.default_params(
        spec, robot, start_t, goal_t, qc_inv=np.eye(2), cost_sigma=cost_sigma,
        epsilon_dist=epsilon_dist, k_s=k_s, k_g=k_g, dtype=dtype,
    )
    th0 = straight_line_traj(start_t[:, :2], goal_t[:, :2],
                             spec.total_time_sec, t)
    return spec, robot, params, th0, sdf


def golden_plan(dev):
    """Plan the stored golden problem in float64 on ``dev``; returns the
    port's PlanResult and the golden arrays."""
    from dgpmp2_tpu_torch.core import gn

    g = dict(np.load(GOLDEN))
    spec, robot, params, th0, sdf = port_problem(
        g["images"], g["start"], g["goal"], dev, torch.float64, int(g["T"]),
        float(g["cost_sigma"]), float(g["epsilon_dist"]), float(g["k_s"]),
        float(g["k_g"]))
    cfg = gn.OptimConfig(reg=float(g["reg"]), max_iters=int(g["iters"]),
                         tol_delta=0.0)
    return gn.plan(spec, robot, params, th0, sdf, cfg), g


def golden_errors(out, g) -> dict:
    """Relative max-abs errors of the port's plan against the golden."""
    def err(name, ref):
        ref = torch.tensor(ref)
        return rel_err(getattr(out, name).detach().cpu(), ref)

    return {k: err(k, g[k]) for k in
            ("th", "err_init", "err_per_iter", "err_ext_per_iter")}


def spd_system(rng, b, t, d, dtype, dev):
    """Block-diagonally dominant SPD system: off blocks N(0, 0.3²), diag
    G Gᵀ/10 + 4I, so every Schur pivot stays far from singular."""
    g = rng.standard_normal((b, t, d, d))
    diag = g @ np.swapaxes(g, -1, -2) * 0.1 + 4.0 * np.eye(d)
    off = 0.3 * rng.standard_normal((b, t - 1, d, d))
    rhs = rng.standard_normal((b, t, d))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in (diag, off, rhs)]


def check_btd(dev, record, bench):
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    rng = np.random.default_rng(1)
    # Tolerances on well-conditioned systems: the kernel and cuSOLVER's
    # batched Cholesky round in different orders, and both stay within a
    # few hundred ulp of the exact solution.
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for d in (4, 6):
            diag, off, rhs = spd_system(rng, B, T + 1, d, dtype, dev)
            x_k = k.launch(diag, off, rhs)
            x_p = tridiag.btd_solve(diag, off, rhs)
            err = rel_err(x_k, x_p)
            print(f"K-BTD random SPD {dtype} D={d}: max rel err vs plain "
                  f"{err:.3e} (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"K-BTD {dtype} D={d}: {err} > {tol}")
            if dtype == torch.float32 and d == 4:
                record["max_abs_err"] = float((x_k - x_p).abs().max())
                record["ms"] = cuda_ms(lambda: k.launch(diag, off, rhs))
                record["plain_ms"] = cuda_ms(
                    lambda: tridiag.btd_solve(diag, off, rhs), reps=5)

    # The bench's own first-iteration system (damped, reg = 0.1).  Its
    # conditioning is set by K_s⁻¹ = 1e4 and the GP's 12/dt³ = 1.2e4, so
    # float32 loses digits in any solver.  Held: the kernel's float32 error
    # against the float64 solve is within 4x the plain version's (+1e-6
    # relative), and the float64 kernel agrees with the float64 plain
    # version to 1e-9.
    spec, robot, params, th0, sdf = bench
    res = graph.eval_residuals(spec, robot, params, th0, sdf)
    diag, off, rhs = gn.damped_system(
        *graph.assemble_from_residuals(spec, params, res), 0.1)
    sys64 = [a.double().contiguous() for a in (diag, off, rhs)]
    x64 = k.launch(*sys64)
    e64 = rel_err(x64, tridiag.btd_solve(*sys64))
    e_k = rel_err(k.launch(diag, off, rhs).double(), x64)
    e_p = rel_err(tridiag.btd_solve(diag, off, rhs).double(), x64)
    print(f"K-BTD bench system: f32 kernel err vs f64 {e_k:.3e}, f32 plain "
          f"err vs f64 {e_p:.3e}; f64 kernel vs f64 plain {e64:.3e}")
    if not (e_k <= 4.0 * e_p + 1e-6 and e64 <= 1e-9):
        raise AssertionError(f"K-BTD bench system: {e_k}, {e_p}, {e64}")


def check_lookup(dev, record):
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k

    rng = np.random.default_rng(2)
    res = 10.0 / IMSIZE
    p = T + 1
    # One point in ten lies outside the world; two lie on its border.
    pts = rng.uniform(-4.99, 4.99, (B, p, 2))
    pts[:, ::10] = rng.uniform(-7.0, 7.0, (B, len(range(0, p, 10)), 2))
    pts[:, 1, 0] = -5.0
    pts[:, 2, 1] = 5.0
    # Tolerances: d blends 4 taps of values of order 1, so reordered
    # float32 rounding stays below 1e-5; the gradient divides by
    # res = 0.078 and so carries ~13x that, well inside 1e-3.  The corner
    # choice itself rounds identically in both versions.
    cases = ((torch.float32, 1e-5, 1e-3), (torch.float64, 1e-12, 1e-10))
    for dtype, tol_d, tol_g in cases:
        sdf = torch.tensor(rng.standard_normal((B, IMSIZE, IMSIZE)),
                           dtype=dtype, device=dev)
        p_t = torch.tensor(pts, dtype=dtype, device=dev)
        for mode in sdf_ops.OOB_MODES:
            d_k, g_k = k.launch(sdf, p_t, res, LIMS, LIMS, mode)
            d_p, g_p = sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS, LIMS, mode)
            ed = float((d_k - d_p).abs().max())
            eg = float((g_k - g_p).abs().max())
            print(f"K-LOOKUP {dtype} {mode}: max abs err d {ed:.3e} "
                  f"(tol {tol_d:g}), grad {eg:.3e} (tol {tol_g:g})")
            if not (ed <= tol_d and eg <= tol_g):
                raise AssertionError(f"K-LOOKUP {dtype} {mode}: {ed}, {eg}")
            if dtype == torch.float32 and mode == "intended":
                record["max_abs_err"] = max(ed, eg)
                record["ms"] = cuda_ms(
                    lambda: k.launch(sdf, p_t, res, LIMS, LIMS, mode))
                record["plain_ms"] = cuda_ms(
                    lambda: sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS, LIMS,
                                                    mode))


def check_golden(dev):
    phase("4 float64 reference check (golden from the JAX package)")
    out, g = golden_plan(dev)
    errs = golden_errors(out, g)
    print("golden relative errors " + json.dumps(errs))
    # 1e-8: both sides are float64 solves of the same well-posed systems;
    # no hinge sits on its activation boundary in this problem.
    bad = {k: v for k, v in errs.items() if not v <= 1e-8}
    if bad:
        raise AssertionError(f"golden mismatch: {bad}")


def check_plan(name, out, n_iter):
    shapes = (tuple(out.th.shape), tuple(out.err_per_iter.shape))
    if shapes != ((B, T + 1, 4), (n_iter, B)):
        raise AssertionError(f"{name}: shapes {shapes}")
    finite = bool(torch.isfinite(out.th).all())
    better = float((out.err_final < out.err_init).double().mean())
    print(f"{name}: finite {finite}, err_final < err_init on "
          f"{better:.4f} of problems, mean err {float(out.err_init.mean()):.4g}"
          f" -> {float(out.err_final.mean()):.4g}, iterations {n_iter}")
    if not (finite and better >= 0.95):
        raise AssertionError(f"{name}: finite={finite} improved={better}")


def main_path(dev, bench_np):
    """Drive the port's entry points at B=1024; returns launch counts."""
    phase("5 main path (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.ops.cuda import btd_solve, sdf_lookup
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot
    from dgpmp2_tpu_torch.utils.config import load_params

    imgs, start, goal = bench_np
    env, pp, gp, obs, opt, robot_data = load_params(
        CONFIGS / "gpmp2_2d_params.yaml", CONFIGS / "robot_2d.yaml",
        CONFIGS / "env_2d_params.yaml")
    planner = DiffGPMP2Planner(
        gp, obs, pp, opt, {"x_lims": env["x_lims"], "y_lims": env["y_lims"]},
        make_robot(robot_data), dtype=torch.float32, device=dev)
    cfg = gn.OptimConfig(reg=0.1, max_iters=50, tol_delta=0.0)
    torch.cuda.synchronize()

    btd_solve.launches = 0
    sdf_lookup.launches = 0
    spec, robot, params, th0, sdf = port_problem(imgs, start, goal, dev,
                                                 torch.float32)
    out_p = planner.plan(th0, start, goal, sdf)
    out_g = gn.plan(spec, robot, params, th0, sdf, cfg)
    torch.cuda.synchronize()
    counts = {"btd_solve": btd_solve.launches,
              "sdf_lookup": sdf_lookup.launches}

    n_p, n_g = planner.cfg.max_iters, cfg.max_iters
    check_plan("DiffGPMP2Planner.plan (YAML config)", out_p, n_p)
    check_plan("core.gn.plan (reg=0.1, 50 iterations)", out_g, n_g)
    # One solve per iteration, one lookup per iteration plus the initial one.
    want = {"btd_solve": n_p + n_g, "sdf_lookup": n_p + n_g + 2}
    print(f"launches {json.dumps(counts)}, expected {json.dumps(want)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts, (spec, robot, params, th0, sdf)


def timing(smi, bench):
    phase("6 timing")
    from dgpmp2_tpu_torch.core import gn

    spec, robot, params, th0, sdf = bench

    def plan_ms(n):
        cfg = gn.OptimConfig(reg=0.1, max_iters=n, tol_delta=0.0)
        return cuda_ms(lambda: gn.plan(spec, robot, params, th0, sdf, cfg),
                       reps=5, warmup=1)

    t50, t200 = plan_ms(50), plan_ms(200)
    per_iter = (t200 - t50) / 150.0
    print(f"[{smi}] core.gn.plan B=1024 T=100 128x128 float32: 50 iterations "
          f"{t50:.3f} ms, 200 iterations {t200:.3f} ms, "
          f"ms per GN iteration {per_iter:.4f}")
    return per_iter


def main():
    smi = device_info()
    dev = torch.device("cuda", 0)
    build()

    phase("3 kernels vs plain (B=1024, T=100, 128x128)")
    bench_np = bench_inputs(B)
    bench = port_problem(*bench_np, dev, torch.float32)
    btd = {"name": "btd_solve", "route": "cuda",
           "source": "dgpmp2_tpu_torch/csrc/btd_solve.cu",
           "replaces": "dgpmp2_tpu/ops/pallas/btd_solve.py:111"}
    lk = {"name": "sdf_lookup", "route": "cuda",
          "source": "dgpmp2_tpu_torch/csrc/sdf_lookup.cu",
          "replaces": "dgpmp2_tpu/ops/pallas/sdf_lookup.py:169"}
    check_btd(dev, btd, bench)
    check_lookup(dev, lk)
    check_golden(dev)
    counts, bench = main_path(dev, bench_np)
    btd["launches"] = counts["btd_solve"]
    lk["launches"] = counts["sdf_lookup"]
    per_iter = timing(smi, bench)
    for rec in (btd, lk):
        print(f"[{smi}] {rec['name']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms")
    print(f"[{smi}] gn_iter_ms_b1024 {per_iter:.4f}")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")}
        for r in (btd, lk)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
