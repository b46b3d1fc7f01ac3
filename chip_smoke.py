#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dgpmp2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build the four CUDA kernels from ``dgpmp2_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: K-BTD and K-LOOKUP at B=1024 problems, T=100, 128x128
   SDFs (K-LOOKUP also with far out-of-grid points); K-LOOKUP3D at B=1024,
   64^3 voxels, P=101; K-LOOKUP-LIMB at B=1024, 128x128, P=101, L=1..3;
4. float64 plans on the small goldens that the JAX package wrote
   (``tests/goldens/torch_port_plan_small.npz``, ``..._plan3d_small.npz``);
5. the 2-D main path: the bench.py problem at B=1024 in float32 through
   ``DiffGPMP2Planner.plan`` (YAML configs) and ``core.gn.plan``;
6. the 3-D path: B=1024 PointRobot3D problems in 64^3 voxel worlds built
   on the card, through ``DiffGPMP2Planner.plan`` (3-D YAMLs) and
   ``core.gn.plan``, and K-BTD on its first-iteration system at D=6;
7. the 2-D lookup engines: the bench problem under
   ``set_lookup_method("pallas_v3_1")`` (K-LOOKUP-LIMB) and ``"pallas"``
   (K-LOOKUP);
8. timing with CUDA events: ms per GN iteration in 2-D and 3-D and each
   kernel beside its plain version.

Every path phase sets all kernel launch counters to 0 just before it and
reads them just after.  The last two lines are JSON: the kernels' record,
then the device record.  Imports no JAX.
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
GOLDEN3D = ROOT / "tests" / "goldens" / "torch_port_plan3d_small.npz"
CONFIGS = ROOT / "dgpmp2_tpu" / "configs"
B, T, IMSIZE, VOX = 1024, 100, 128, 64
LIMS = (-5.0, 5.0)
KERNELS = ("btd_solve", "sdf_lookup", "sdf_lookup3d", "sdf_lookup_limbs")


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


_FLUSH = []


def cuda_ms(fn, reps=20, warmup=3, inner=1, flush=False):
    """Median milliseconds of one call of ``fn``: CUDA events around
    ``inner`` back-to-back calls, over ``reps`` runs after ``warmup``
    untimed ones.  ``flush`` overwrites a 256 MiB buffer before each run so
    that the 50 MB L2 holds none of ``fn``'s inputs, as in the GN loop,
    where other work runs between two launches of a kernel."""
    if flush and not _FLUSH:
        _FLUSH.append(torch.empty(1 << 26, device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_ms(record, kernel, plain):
    """A kernel's and its plain version's ms into ``record``: L2 flushed
    before each timed call (``ms``, ``plain_ms``), and back to back over
    20 calls with a warm L2 (``warm_ms``, ``plain_warm_ms``)."""
    record["ms"] = cuda_ms(kernel, flush=True)
    record["plain_ms"] = cuda_ms(plain, reps=5, flush=True)
    record["warm_ms"] = cuda_ms(kernel, inner=20)
    record["plain_warm_ms"] = cuda_ms(plain, reps=5, inner=20)


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


def bench3d_inputs(b: int, dev, seed: int = 0):
    """benchmarks/bench_throughput.py:109-146's 3-D worlds, carved on
    ``dev``: one 12^3 box per 64^3 occupancy grid (uint8, 1 = free), starts
    near (-4, -4, -4) and goals near (4, 4, 4)."""
    rng = np.random.default_rng(seed)
    r = torch.tensor(rng.integers(10, VOX - 22, (b, 3)), device=dev)
    start = np.zeros((b, 6))
    start[:, :3] = rng.uniform(-4.5, -3.5, (b, 3))
    goal = np.zeros((b, 6))
    goal[:, :3] = rng.uniform(3.5, 4.5, (b, 3))
    ax = torch.arange(VOX, device=dev)
    inside = [(ax >= r[:, i:i + 1]) & (ax < r[:, i:i + 1] + 12)
              for i in range(3)]
    box = (inside[0][:, :, None, None] & inside[1][:, None, :, None]
           & inside[2][:, None, None, :])
    return (~box).to(torch.uint8), start, goal


def port_problem(occupancy, start, goal, dev, dtype, t=T, cost_sigma=0.05,
                 epsilon_dist=0.4, k_s=0.01, k_g=0.01):
    """A bench problem in the port: SDFs built on ``dev`` by the port's
    exact EDT, fixed-covariance params and straight-line seeds.  (B, H, W)
    occupancy plans 2-D point robots; (B, D, H, W) voxels plan 3-D ones."""
    from dgpmp2_tpu_torch.core import graph
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.robots import PointRobot2D, PointRobot3D
    from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

    occupancy = torch.as_tensor(occupancy, device=dev)
    res = 10.0 / occupancy.shape[-1]
    if occupancy.ndim == 4:
        dof, robot = 3, PointRobot3D()
        spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                               z_lims=LIMS)
        sdf = sdf_ops.sdf_from_occupancy_3d(occupancy, res=res, dtype=dtype)
    else:
        dof, robot = 2, PointRobot2D()
        spec = graph.GraphSpec(total_time_step=t)
        sdf = sdf_ops.sdf_from_occupancy(occupancy, res=res, dtype=dtype)
    start_t = torch.tensor(start, dtype=dtype, device=dev)
    goal_t = torch.tensor(goal, dtype=dtype, device=dev)
    params = graph.default_params(
        spec, robot, start_t, goal_t, qc_inv=np.eye(dof),
        cost_sigma=cost_sigma, epsilon_dist=epsilon_dist, k_s=k_s, k_g=k_g,
        dtype=dtype,
    )
    th0 = straight_line_traj(start_t[:, :dof], goal_t[:, :dof],
                             spec.total_time_sec, t)
    return spec, robot, params, th0, sdf


def golden_plan(dev, path=GOLDEN):
    """Plan a stored golden problem in float64 on ``dev``; returns the
    port's PlanResult and the golden arrays."""
    from dgpmp2_tpu_torch.core import gn

    g = dict(np.load(path))
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
                kernel_ms(record, lambda: k.launch(diag, off, rhs),
                          lambda: tridiag.btd_solve(diag, off, rhs))
    check_btd_bench_system("bench system", bench)


def check_btd_bench_system(name, bench):
    """K-BTD on a bench problem's own first-iteration system (damped,
    reg = 0.1).  Its conditioning is set by K_s⁻¹ = 1e4 and the GP's
    12/dt³ = 1.2e4, so float32 loses digits in any solver.  Held: the
    kernel's float32 error against the float64 solve is within 4x the plain
    version's (+1e-6 relative), and the float64 kernel agrees with the
    float64 plain version to 1e-9."""
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    spec, robot, params, th0, sdf = bench
    res = graph.eval_residuals(spec, robot, params, th0, sdf)
    diag, off, rhs = gn.damped_system(
        *graph.assemble_from_residuals(spec, params, res), 0.1)
    sys64 = [a.double().contiguous() for a in (diag, off, rhs)]
    x64 = k.launch(*sys64)
    e64 = rel_err(x64, tridiag.btd_solve(*sys64))
    e_k = rel_err(k.launch(diag, off, rhs).double(), x64)
    e_p = rel_err(tridiag.btd_solve(diag, off, rhs).double(), x64)
    print(f"K-BTD {name} (D={diag.shape[-1]}): f32 kernel err vs f64 "
          f"{e_k:.3e}, f32 plain err vs f64 {e_p:.3e}; f64 kernel vs f64 "
          f"plain {e64:.3e}")
    if not (e_k <= 4.0 * e_p + 1e-6 and e64 <= 1e-9):
        raise AssertionError(f"K-BTD {name}: {e_k}, {e_p}, {e64}")


# Lookup tolerances: d blends taps of values of order 1, so reordered
# float32 rounding would stay below 1e-5; the gradient divides by res
# (0.078 or 0.156) and so carries ~13x that, well inside 1e-3.  The kernels
# round as their plain versions do (no fused multiply-add), so the errors
# read 0 or close to it; the corner choice itself rounds identically.
LOOKUP_TOLS = ((torch.float32, 1e-5, 1e-3), (torch.float64, 1e-12, 1e-10))


def compare(name, got, want, tol_d, tol_g):
    ed = float((got[0] - want[0]).abs().max())
    eg = float((got[1] - want[1]).abs().max())
    print(f"{name}: max abs err d {ed:.3e} (tol {tol_d:g}), grad {eg:.3e} "
          f"(tol {tol_g:g})")
    if not (ed <= tol_d and eg <= tol_g):
        raise AssertionError(f"{name}: {ed}, {eg}")
    return max(ed, eg)


def lookup_points(rng, p, ndim):
    """(B, p, ndim) query points: random in the world, one in ten outside
    it, some exactly on its border."""
    pts = rng.uniform(-4.99, 4.99, (B, p, ndim))
    pts[:, ::10] = rng.uniform(-7.0, 7.0, (B, len(range(0, p, 10)), ndim))
    pts[:, 1, 0] = -5.0
    pts[:, 2, 1] = 5.0
    return pts


def check_lookup(dev, record):
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k

    rng = np.random.default_rng(2)
    res = 10.0 / IMSIZE
    pts = lookup_points(rng, T + 1, 2)
    # Far out-of-grid points: a pixel coordinate beyond int range must not
    # wrap the corner index (the kernel clamps the floor before its cast).
    pts[:, 3] = (1e10, 0.3)
    pts[:, 4] = (-0.7, -1e10)
    pts[:, 5] = (1e10, 1e10)
    for dtype, tol_d, tol_g in LOOKUP_TOLS:
        sdf = torch.tensor(rng.standard_normal((B, IMSIZE, IMSIZE)),
                           dtype=dtype, device=dev)
        p_t = torch.tensor(pts, dtype=dtype, device=dev)
        for mode in sdf_ops.OOB_MODES:
            err = compare(
                f"K-LOOKUP {dtype} {mode}",
                k.launch(sdf, p_t, res, LIMS, LIMS, mode),
                sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS, LIMS, mode),
                tol_d, tol_g)
            if dtype == torch.float32 and mode == "intended":
                record["max_abs_err"] = err
                kernel_ms(record,
                          lambda: k.launch(sdf, p_t, res, LIMS, LIMS, mode),
                          lambda: sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS,
                                                          LIMS, mode))


def trajectory_points(rng, b, p, noise=0.1):
    """(b, p, 3) points along straight start -> goal paths with noise: the
    access pattern of a plan's states."""
    t = np.linspace(0.0, 1.0, p)[None, :, None]
    s = rng.uniform(-4.5, -3.5, (b, 1, 3))
    g = rng.uniform(3.5, 4.5, (b, 1, 3))
    return s + t * (g - s) + noise * rng.standard_normal((b, p, 3))


def check_lookup3d(dev, record):
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as k

    rng = np.random.default_rng(3)
    res = 10.0 / VOX
    p = T + 1
    pts = trajectory_points(rng, B, p)
    pts[:, ::10] = rng.uniform(-7.0, 7.0, (B, len(range(0, p, 10)), 3))
    pts[:, 1] = (-5.0, 5.0, 5.0)  # a corner of the world
    pts[:, 2, 2] = 5.0  # a face
    pts[:, 3] = (1e10, -1e10, 0.2)  # far outside the grid
    for dtype, tol_d, tol_g in LOOKUP_TOLS:
        sdf = torch.randn((B, VOX, VOX, VOX), dtype=dtype, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
        p_t = torch.tensor(pts, dtype=dtype, device=dev)
        for mode in sdf_ops.OOB_MODES:
            args = (sdf, p_t, res, LIMS, LIMS, LIMS, mode)
            err = compare(f"K-LOOKUP3D {dtype} {mode}", k.launch(*args),
                          sdf_ops.trilinear_lookup(*args), tol_d, tol_g)
            if dtype == torch.float32 and mode == "intended":
                record["max_abs_err"] = err
                kernel_ms(record, lambda: k.launch(*args),
                          lambda: sdf_ops.trilinear_lookup(*args))
        del sdf


def check_limbs(dev, record):
    """K-LOOKUP-LIMB against its plain version at L = 1, 2, 3 (both read the
    same limbs), and at L = 1 timed beside K-LOOKUP on the float32 SDF."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k_exact
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as k

    rng = np.random.default_rng(4)
    res = 10.0 / IMSIZE
    pts = lookup_points(rng, T + 1, 2)
    sdf = torch.tensor(rng.standard_normal((B, IMSIZE, IMSIZE)),
                       dtype=torch.float32, device=dev)
    p_t = torch.tensor(pts, dtype=torch.float32, device=dev)
    tol_d, tol_g = LOOKUP_TOLS[0][1:]
    exact = sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS, LIMS, "intended")
    for n_limbs in (3, 2, 1):
        limbs = sdf_ops.limb_split(sdf, n_limbs)
        args = (limbs, p_t, res, LIMS, LIMS)
        got = k.launch(*args)
        err = compare(f"K-LOOKUP-LIMB L={n_limbs}", got,
                      sdf_ops.bilinear_lookup_limbs(*args), tol_d, tol_g)
        rec = {}
        kernel_ms(rec, lambda: k.launch(*args),
                  lambda: sdf_ops.bilinear_lookup_limbs(*args))
        print(f"  L={n_limbs}: max abs err d against the exact float32 "
              f"lookup {float((got[0] - exact[0]).abs().max()):.3e}; "
              f"kernel {rec['ms']:.4f} ms (warm {rec['warm_ms']:.4f}), "
              f"plain {rec['plain_ms']:.4f} ms")
        if n_limbs == 1:
            record.update(rec, max_abs_err=err)
    def exact_launch():
        return k_exact.launch(sdf, p_t, res, LIMS, LIMS)

    record["exact_ms"] = cuda_ms(exact_launch, flush=True)
    record["exact_warm_ms"] = cuda_ms(exact_launch, inner=20)
    record["split_ms"] = cuda_ms(lambda: sdf_ops.limb_split(sdf, 1))


def check_golden(dev):
    phase("4 float64 reference check (goldens from the JAX package)")
    for path in (GOLDEN, GOLDEN3D):
        out, g = golden_plan(dev, path)
        errs = golden_errors(out, g)
        print(f"{path.name} relative errors " + json.dumps(errs))
        # 1e-8: both sides are float64 solves of the same well-posed
        # systems; no hinge sits on its activation boundary in either.
        bad = {k: v for k, v in errs.items() if not v <= 1e-8}
        if bad:
            raise AssertionError(f"{path.name} mismatch: {bad}")


def check_plan(name, out, n_iter, dof=2):
    shapes = (tuple(out.th.shape), tuple(out.err_per_iter.shape))
    if shapes != ((B, T + 1, 2 * dof), (n_iter, B)):
        raise AssertionError(f"{name}: shapes {shapes}")
    finite = bool(torch.isfinite(out.th).all())
    better = float((out.err_final < out.err_init).double().mean())
    print(f"{name}: finite {finite}, err_final < err_init on "
          f"{better:.4f} of problems, mean err {float(out.err_init.mean()):.4g}"
          f" -> {float(out.err_final.mean()):.4g}, iterations {n_iter}")
    if not (finite and better >= 0.95):
        raise AssertionError(f"{name}: finite={finite} improved={better}")


def counters():
    """The kernel wrappers' modules, by kernel name."""
    from dgpmp2_tpu_torch.ops.cuda import (btd_solve, sdf_lookup,
                                           sdf_lookup3d, sdf_lookup_limbs)

    return dict(zip(KERNELS, (btd_solve, sdf_lookup, sdf_lookup3d,
                              sdf_lookup_limbs)))


def drive(name, run, want):
    """Run one path with every launch counter set to 0 just before and read
    just after; the counts must equal ``want`` (absent kernels: 0)."""
    mods = counters()
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    out = run()
    torch.cuda.synchronize()
    counts = {k: m.launches for k, m in mods.items()}
    want = {k: want.get(k, 0) for k in KERNELS}
    print(f"{name} launches {json.dumps(counts)}, expected {json.dumps(want)}")
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    return out, counts


def planner_from_yaml(dim, dev):
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot
    from dgpmp2_tpu_torch.utils.config import load_params

    env, pp, gp, obs, opt, robot_data = load_params(
        CONFIGS / f"gpmp2_{dim}_params.yaml", CONFIGS / f"robot_{dim}.yaml",
        CONFIGS / f"env_{dim}_params.yaml")
    lims = {k: env[k] for k in ("x_lims", "y_lims", "z_lims") if k in env}
    return DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(robot_data),
                            dtype=torch.float32, device=dev)


def main_path(dev, bench_np):
    """Drive the port's 2-D entry points at B=1024; returns launch counts."""
    phase("5 main path (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn

    imgs, start, goal = bench_np
    planner = planner_from_yaml("2d", dev)
    cfg = gn.OptimConfig(reg=0.1, max_iters=50, tol_delta=0.0)
    n_p, n_g = planner.cfg.max_iters, cfg.max_iters
    outs = {}

    def run():
        bench = port_problem(imgs, start, goal, dev, torch.float32)
        outs["p"] = planner.plan(bench[3], start, goal, bench[4])
        outs["g"] = gn.plan(*bench, cfg)
        return bench

    # One solve per iteration, one lookup per iteration plus the initial one.
    bench, counts = drive("2-D path", run, {"btd_solve": n_p + n_g,
                                            "sdf_lookup": n_p + n_g + 2})
    check_plan("DiffGPMP2Planner.plan (YAML config)", outs["p"], n_p)
    check_plan("core.gn.plan (reg=0.1, 50 iterations)", outs["g"], n_g)
    return counts, bench


def path3d(dev, smi):
    """The 3-D path at B=1024: SDFs built on the card, then both entry
    points; returns launch counts and the float32 problem."""
    phase("6 3-D path (B=1024, 64^3 voxels, float32)")
    from dgpmp2_tpu_torch.core import gn

    occ, start, goal = bench3d_inputs(B, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    bench = port_problem(occ, start, goal, dev, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"[{smi}] 3-D SDF build B=1024 64^3 (66^3 padded) on the card: "
          f"{build_s:.3f} s, peak memory {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB already held")
    sdf = bench[4]
    if tuple(sdf.shape) != (B, VOX, VOX, VOX) or not bool(
            torch.isfinite(sdf).all()):
        raise AssertionError(f"3-D SDF: shape {tuple(sdf.shape)}")
    planner = planner_from_yaml("3d", dev)
    cfg = gn.OptimConfig(reg=0.1, max_iters=50, tol_delta=0.0)
    n_p, n_g = planner.cfg.max_iters, cfg.max_iters
    outs = {}

    def run():
        outs["p"] = planner.plan(bench[3], start, goal, sdf)
        outs["g"] = gn.plan(*bench, cfg)

    _, counts = drive("3-D path", run, {"btd_solve": n_p + n_g,
                                        "sdf_lookup3d": n_p + n_g + 2})
    check_plan("3-D DiffGPMP2Planner.plan (3-D YAMLs)", outs["p"], n_p, 3)
    check_plan("3-D core.gn.plan (reg=0.1, 50 iterations)", outs["g"], n_g, 3)
    check_btd_bench_system("3-D bench system", bench)
    return counts, bench


def engines(bench):
    """The 2-D bench problem under the limb engine and the 'pallas' engine."""
    phase("7 2-D lookup engines (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    cfg = gn.OptimConfig(reg=0.1, max_iters=50, tol_delta=0.0)
    try:
        sdf_ops.set_lookup_method("pallas_v3_1")
        out, counts = drive("pallas_v3_1", lambda: gn.plan(*bench, cfg), {
            "btd_solve": 50, "sdf_lookup_limbs": 51})
        check_plan("core.gn.plan under pallas_v3_1 (bf16 SDF)", out, 50)
        sdf_ops.set_lookup_method("pallas")
        cfg5 = gn.OptimConfig(reg=0.1, max_iters=5, tol_delta=0.0)
        drive("pallas", lambda: gn.plan(*bench, cfg5),
              {"btd_solve": 5, "sdf_lookup": 6})
    finally:
        sdf_ops.set_lookup_method("auto")
    return counts


def plan_ms(bench):
    """ms per GN iteration: (200-iteration plan - 50-iteration plan) / 150,
    each the median of 5 CUDA-event runs after one warm-up."""
    from dgpmp2_tpu_torch.core import gn

    def run(n):
        cfg = gn.OptimConfig(reg=0.1, max_iters=n, tol_delta=0.0)
        return cuda_ms(lambda: gn.plan(*bench, cfg), reps=5, warmup=1)

    t50, t200 = run(50), run(200)
    return t50, t200, (t200 - t50) / 150.0


def timing(smi, bench, bench3):
    phase("8 timing")
    t50, t200, per_iter = plan_ms(bench)
    print(f"[{smi}] core.gn.plan B=1024 T=100 128x128 float32: 50 iterations "
          f"{t50:.3f} ms, 200 iterations {t200:.3f} ms, "
          f"ms per GN iteration {per_iter:.4f}")
    t50, t200, per_iter3 = plan_ms(bench3)
    print(f"[{smi}] 3-D core.gn.plan B=1024 T=100 64^3 float32: 50 "
          f"iterations {t50:.3f} ms, 200 iterations {t200:.3f} ms, "
          f"ms per GN iteration {per_iter3:.4f}")
    return per_iter, per_iter3


def main():
    smi = device_info()
    dev = torch.device("cuda", 0)
    build()

    phase("3 kernels vs plain (B=1024, T=100, 128x128 and 64^3)")
    bench_np = bench_inputs(B)
    bench = port_problem(*bench_np, dev, torch.float32)
    recs = {
        "btd_solve": {"source": "dgpmp2_tpu_torch/csrc/btd_solve.cu",
                      "replaces": "dgpmp2_tpu/ops/pallas/btd_solve.py:111"},
        "sdf_lookup": {"source": "dgpmp2_tpu_torch/csrc/sdf_lookup.cu",
                       "replaces": "dgpmp2_tpu/ops/pallas/sdf_lookup.py:169 "
                                   "and dgpmp2_tpu/ops/pallas/sdf_lookup.py:32"},
        "sdf_lookup3d": {
            "source": "dgpmp2_tpu_torch/csrc/sdf_lookup3d.cu",
            "replaces": "dgpmp2_tpu/ops/pallas/sdf_lookup3d.py:50"},
        "sdf_lookup_limbs": {
            "source": "dgpmp2_tpu_torch/csrc/sdf_lookup_limbs.cu",
            "replaces": "dgpmp2_tpu/ops/pallas/sdf_lookup.py:272"},
    }
    for name, rec in recs.items():
        rec.update(name=name, route="cuda")
    check_btd(dev, recs["btd_solve"], bench)
    check_lookup(dev, recs["sdf_lookup"])
    check_lookup3d(dev, recs["sdf_lookup3d"])
    check_limbs(dev, recs["sdf_lookup_limbs"])
    check_golden(dev)
    counts2, bench = main_path(dev, bench_np)
    counts3, bench3 = path3d(dev, smi)
    counts_limb = engines(bench)
    recs["btd_solve"]["launches"] = counts2["btd_solve"]
    recs["sdf_lookup"]["launches"] = counts2["sdf_lookup"]
    recs["sdf_lookup3d"]["launches"] = counts3["sdf_lookup3d"]
    recs["sdf_lookup_limbs"]["launches"] = counts_limb["sdf_lookup_limbs"]
    per_iter, per_iter3 = timing(smi, bench, bench3)
    for rec in recs.values():
        print(f"[{smi}] {rec['name']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms (L2 flushed); back to back kernel "
              f"{rec['warm_ms']:.4f} ms, plain {rec['plain_warm_ms']:.4f} ms")
    limb = recs["sdf_lookup_limbs"]
    print(f"[{smi}] K-LOOKUP-LIMB L=1 {limb['ms']:.4f} ms (warm "
          f"{limb['warm_ms']:.4f}) beside K-LOOKUP {limb['exact_ms']:.4f} ms "
          f"(warm {limb['exact_warm_ms']:.4f}) on the same points; limb "
          f"split {limb['split_ms']:.4f} ms per call")
    print(f"[{smi}] gn_iter_ms_b1024 {per_iter:.4f}")
    print(f"[{smi}] gn_iter_ms_b1024_3d {per_iter3:.4f}")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")}
        for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
