#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dgpmp2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build the five CUDA kernels from ``dgpmp2_tpu_torch/csrc`` with nvcc,
   printing every kernel's registers and spills (36 K-BTD instances: D = 1
   to 16, the wide kernel of D = 17-32 and the block kernel of D > 32, in
   two dtypes);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: K-BTD at every D from 1 to 32 (B=1024; T=101 up to D=8,
   T=41 above) in float32 and float64 on random SPD systems and at the
   edge shapes B in {1, 1000, 4096} x T in {1, 2, 41}, past D = 32 at
   D = 33, 40, 48, 64 and at the largest D whose rows fit the card's shared
   memory and the next (B=1024, T=41, both dtypes, each timed beside its
   bound and its plain version), then on the bench
   problem's own system, then timed at the paths' shapes (2-D, 3-D,
   multistart pool, plan_batch, 4-link arm) beside its bound and
   ``torch.linalg.solve`` on the dense Λ, and at D = 18 and 32 (B=1024,
   T=41, both dtypes) beside its bound and plain version; K-LOOKUP
   (B=1024, P=101, 128x128, far out-of-grid points too) and K-LOOKUP3D
   (B=1024, 64^3 voxels, P=101) bit-equal in both dtypes and OOB modes,
   also at edge shapes of their 128-point tiles, at the paths' shapes of
   more than one wave of blocks (P = 246, 401, the B=4096 multistart pool),
   on the points each path's residuals hand to the lookup, and on a view
   off the 16-byte grid; K-LOOKUP timed on the bench plan's own points;
   K-LOOKUP-LIMB bit-equal at L = 1, 2, 3 on the 2-D bench plan's points,
   uniform random points, the 2-link arm's P=246 and the B=4096 pool, and
   at the tile edges, timed at L=1 on the bench plan's points beside the
   split of the SDF into its packed limbs (once per plan).  Every kernel's
   ``ms`` is its device-only time (``torch.profiler``, L2 flushed), beside
   a CUDA-graph replay, CUDA events around one call (host-inclusive), the
   host µs per ``launch()`` call, its bound and its plain version;
4. float64 plans on the small goldens that the JAX package wrote
   (``tests/goldens/torch_port_plan_small.npz``, ``..._plan3d_small.npz``,
   ``..._plan_ext_small.npz``: the 2-link arm, the task-space 3-link
   arm, the heading robot and GP interpolation with velocity limits; and
   ``..._learned_small.npz``: the learned planner, feed-forward and GRU);
5. the 2-D main path: the bench.py problem at B=1024 in float32 through
   ``DiffGPMP2Planner.plan`` (YAML configs) and ``core.gn.plan``;
6. the 3-D path: B=1024 PointRobot3D problems in 64^3 voxel worlds built
   on the card, through ``DiffGPMP2Planner.plan`` (3-D YAMLs) and
   ``core.gn.plan``, and K-BTD on its first-iteration system at D=6;
7. the 2-D lookup engines: the bench problem under
   ``set_lookup_method("pallas_v3_1")`` (K-LOOKUP-LIMB: one split of the
   SDF, one launch per lookup) and ``"pallas"`` (K-LOOKUP);
8. the constrained robots at B=1024 in float32 through
   ``DiffGPMP2Planner`` built from the YAMLs: the 2-link arm (self-collision,
   joint limits), the heading robot (nonholonomic, D=6), the task-space
   3-link arm (workspace goal, self-collision, joint limits, D=6), the
   bench problem with GP interpolation and velocity limits, the 4-link arm
   (D=8), the 5-link arm (D=10, 20 iterations), the 9-link arm (D=18,
   20 LM iterations, every problem improved) and the 17-link arm (D=34,
   the block K-BTD, 20 LM iterations, every problem improved); then
   ``GPMP2Planner.plan_batch`` (LM, float64) on B=256 bench problems;
9. multistart: the ``benchmarks/bench_multistart.py`` problem (B=256, K=16)
   through ``GPMP2Planner.plan_multistart``, full pool and staged, for four
   seeds of the perturbation draws;
10. timing with CUDA events: ms per GN iteration in 2-D (also under
    ``pallas_v3_1``), 3-D, for the 2- and 4-link arms and the heading
    robot, ms per multistart batch, ms per learned GN iteration (B=1024,
    T=100) and the learned encoder's ms per plan, and each kernel's times
    from phase 3;
11. the learned planner (``LearnedDiffGPMP2Planner``) at full width in
    float32: the 2-D campaign configuration (bounded eps, feed-forward
    head, B=1024, 128x128, 50 GN iterations, ``track_best``; its first 5
    iterations at static init against ``core.gn.plan`` with the static
    covariances), the GRU head with random weights, the 3-D path
    (PointRobot3D, 32^3 voxels built on the card, T=20, LM, ConvEncoder3D),
    ``plan_multistart`` (B=256, K=16, full and staged) on the multistart
    problem; then the gradient of ``err_ext`` with respect to every weight
    (B=64, 5 iterations, float64) on the card against the same on the CPU,
    with the head's output decoded in float64 and, as shipped, in float32;
12. data generation, every generator through the port's modules on the
    card in float32: the JAX golden of a small forest split
    (``tests/goldens/torch_port_data_small.npz``) remade exactly (maps,
    starts, goals and the generator's state; labels to 1e-4); (a)
    ``data.generate.generate_split`` at the campaign's width (forest,
    128x128, T=100, 4 problems a world, LM of 60 iterations with
    ``track_best``): 96 train and 16 test worlds; (b) its
    ``--rrtstar_init`` branch on 2 worlds (the port's native RRT*); (c)
    ``data.generate3d.generate_split3d`` (boxes3d, 32^3, T=20, LM of 40
    iterations, 16 worlds); (d) ``data.generate_im.generate``
    (multi_obstacle, 128x128, 200 + 50 worlds, host EDT) and
    ``data.generate_paths.add_expert_paths`` on its test split (random
    pairs, 2 a world, GN of 60 iterations); (e)
    ``data.sensitivity.run_sweep`` over (a)'s test split (7 sigmas, batch
    16); (f) ``core.seeds.rrt_seed_batch`` on 16 of its problems, fed to
    ``core.multistart.plan_multistart`` (K=16) beside the same draws
    without them.  Every label is read back from disk and re-checked with
    the plain lookup on the CPU; each generator's launches equal its plans'
    iterations (K-BTD) and their lookups plus the re-validations (K-LOOKUP,
    K-LOOKUP3D); seconds per world, plans per world, acceptance, and one
    expert plan's device-busy share and launches per iteration are printed;
13. learned-planner training on phase 12's 96 train worlds:
    ``train_planner.main`` with the campaign's eps_bounded configuration at
    full width (batch 128, unroll 10 in windows of 5, Adam) for 3 epochs
    with a validation pass and a checkpoint, resumed for a fourth, then
    ``test_planner.main``; one training step timed (CUDA events) and
    profiled (device busy, the encoder's share, launches); K-LOOKUP-BWD
    against its autograd replay in both dtypes and OOB modes at the tile
    edges, the paths' shapes and one training step's own lookups, timed;
    the launch floor of K-LOOKUP and K-LOOKUP-BWD (B=1, P=1) beside a
    one-element fill; a float64 training step on the card against the CPU
    (chunked and LM paths);
14. serving: ``serve.PlanningService`` on the card in float32, driven by
    concurrent ``submit()``s through ``tools/bench_serve_torch.py``'s
    functions, each sub-phase with its worlds registered and a warm-up
    first: (a) the 2-D YAML planner (T=100, 50 GN iterations, batch 256,
    window 5 ms) on the bench world at concurrency 1, 8, 64 and 256 (3
    rounds each) through the world bank, 256 again with inline SDFs, 64
    with warm starts, 5 requests padded to 256 against a direct plan, and
    8 under ``pallas_v3_1`` (one limb split per dispatch); (b) 3-D (the
    3-D YAMLs at 50 iterations, 16 worlds of 64^3 built on the card, batch
    256, bank and inline); (c) ``MultistartPlanningAdapter`` (K=16, LM,
    batch 64) and RRT*-seeded (2 seeds, batch 16, a binding iteration cap,
    replayed); (d) ``LearnedPlanningAdapter`` (phase 11's eps_bounded
    planner, random weights from a numpy seed, batch 256); (e)
    ``TaskSpacePlanningAdapter`` (phase 8's task-space arm, LM, batch 64),
    cold (the adapter's cold seed, the arm at rest) and seeded at rest as
    phase 8 seeds it: both equal phase 8's ``gn.plan`` of the same problems
    bit for bit, tip share included.
    Every response finite and improved (95 %), its batch fill and
    iterations right, one dispatch per full batch, bank and inline equal,
    a request's plan the same at any row; plans/s, p50/p99, the service's
    stats and one dispatch's device-busy share and launches per iteration;
15. oracle, envs, capture, mesh: (a) ``core.dense.assemble_dense`` on the
    card in float64 for 4 problems of each family at its path's own T and
    robot (the 2-D bench, the heading robot, GP interpolation with velocity
    limits, the 2-, task-space 3-, 4- and 9-link arms):
    ``ops.tridiag.btd_to_dense`` of the block assembly equals AᵀKA and its
    rhs AᵀKb to 1e-10 relative, the damped K-BTD solve ``solve_dense`` to
    1e-9; (b) ``envs.Env2D`` on a campaign forest world (128²) queried at
    phase 5's 1024x101 trajectory points and ``envs.Env3D`` on phase 6's
    64³ world at 1024x101 3-D seeds, through K-LOOKUP and K-LOOKUP3D, each
    bit-equal to the plain lookup on the card; transforms round-tripped to
    1e-12, ``slice_env2d`` the 3-D field's slice; (c) 20 GN steps of the
    2-D bench (B=1024, float32) captured in one CUDA graph
    (``utils.profiling.CapturedSteps``): a replay bit-equal to the eager
    steps; ms per iteration captured (``time_compiled``) and eager; (d)
    ``PlanningService(mesh=)`` with phase 14 (a)'s planner at batch 256 on
    a mesh of the one card, on a mesh of two entries of it (two shards of
    128 rows) and on one of every visible card when there are more: 256
    requests by the bank, 256 inline and 200 by the bank (56 pad rows, all
    in the last shard) bit-equal to the unsharded service; batch 255 on a
    mesh of two entries refused.

Every time printed carries the card's name and power limit.

Every path phase sets all kernel launch counters, and K-LOOKUP-LIMB's
count of SDF splits, to 0 just before it and reads them just after.  A
CUDA-graph capture counts its launches once, at capture, where nothing
runs: that count stands for the graph's first replay, and phase 15 (c)
replays its graph once inside its window.  The last two lines are JSON: the kernels' record
(launches summed over the paths, times, bounds, library times), then the
device record.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import json
import re
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
GOLDEN_EXT = ROOT / "tests" / "goldens" / "torch_port_plan_ext_small.npz"
GOLDEN_LEARNED = ROOT / "tests" / "goldens" / "torch_port_learned_small.npz"
CONFIGS = ROOT / "dgpmp2_tpu" / "configs"
B, T, IMSIZE, VOX = 1024, 100, 128, 64
LIMS = (-5.0, 5.0)
KERNELS = ("btd_solve", "sdf_lookup", "sdf_lookup3d", "sdf_lookup_limbs",
           "sdf_lookup_bwd")


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    rows = ptxas_summary(_build.build_log)
    for name, regs, spill_st, spill_ld, smem in rows:
        print(f"ptxas {kernel_name(name)}: {regs} registers, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B, shared {smem} B")
    # Each D of the narrow kernel, the wide and the block kernel, in two
    # dtypes.
    want = 2 * (BTD_NARROW + 2)
    n_btd = sum("btd_solve_kernel" in r[0] for r in rows)
    if n_btd != want:
        raise AssertionError(f"ptxas reported {n_btd} K-BTD kernels, not "
                             f"{want}")


def kernel_name(mangled):
    """``btd_solve_kernel<float, 4>``-style name of a mangled kernel."""
    for m in re.finditer(r"(?=(\d+)([a-z_]\w*))", mangled):
        n, ident = int(m[1]), m[2][:int(m[1])]
        if len(ident) == n and "_kernel" in ident:
            args = re.match(r"I(.*?)E", m[2][n:])
            if not args:
                return ident
            args = re.sub(r"Li(\d+)", r",\1", args[1])
            args = args.replace("f", "float,").replace("d", "double,")
            return f"{ident}<{', '.join(a for a in args.split(',') if a)}>"
    return mangled


def ptxas_summary(log):
    """(kernel, registers, spill store bytes, spill load bytes, shared
    bytes) of each kernel in nvcc's ``-Xptxas -v`` output."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m[1]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m[1]), *spill,
                         int(smem[1]) if smem else 0))
            name, spill = None, (0, 0)
    return rows


_FLUSH = []


def flush_l2():
    """Overwrite a 256 MiB buffer, so that the 50 MB L2 holds none of the
    next kernel's inputs, as in the GN loop, where other work runs between
    two launches of a kernel."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(1 << 26, device="cuda"))
    _FLUSH[0].zero_()


def cuda_ms(fn, reps=20, warmup=3, inner=1, flush=False, best=False):
    """Median (the least with ``best``) milliseconds of one call of
    ``fn``: CUDA events around ``inner`` back-to-back calls, over ``reps``
    runs after ``warmup`` untimed ones, the L2 flushed before each run with
    ``flush``.  The window holds the host's work of the call as well: for
    a kernel whose wrapper takes longer than the kernel, it is
    host-inclusive."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush:
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return min(times) if best else statistics.median(times)


def device_ms(fn, kernel, reps=20):
    """Device-only ms of one launch: ``torch.profiler``'s self device time
    of the kernels whose name holds ``kernel``, over ``reps`` calls of
    ``fn`` (one launch each), each after the L2 flush, divided by their
    launch count.  The profiler may drop a few launches' records; a window
    that shows fewer than ``reps`` is taken again, up to three times, and
    the last one used if it shows any; if none shows a launch, the
    CUDA-graph replay's time (:func:`graph_ms`) stands in, said so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        flush_l2()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        n = sum(e.count for e in rows)
        if n == reps:
            break
    if n == 0:
        # A rare window in which the profiler records no kernel at all
        # (seen once for K-LOOKUP-LIMB in a run that had profiled every
        # kernel before it): the CUDA-graph replay's time, warm L2, instead.
        ms = graph_ms(fn)
        print(f"device_ms: the profiler saw no launch of {kernel} in three "
              f"windows; its CUDA-graph time {ms:.4f} ms stands in")
        return ms
    if n != reps:
        print(f"device_ms: the profiler saw {n} of {reps} launches of "
              f"{kernel}; the time is their mean")
    return sum(e.self_device_time_total for e in rows) / n / 1e3


def graph_ms(fn, n=100, reps=5):
    """ms of one launch from the replay of a CUDA graph of ``n`` captured
    back-to-back calls of ``fn`` (warm L2, no host work in the window):
    the cross-check of :func:`device_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = cuda_ms(graph.replay, reps=reps, warmup=1) / n
    del graph
    return ms


def host_us(fn, n=1000):
    """Host µs per call of ``fn``: ``time.perf_counter`` over ``n`` calls
    with no synchronize in between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def kernel_ms(record, kernel, plain, name, plain_reps=5):
    """A kernel's times into ``record``: ``ms`` device-only (profiler, L2
    flushed), ``graph_ms`` (CUDA graph, warm L2), ``event_ms`` (CUDA events
    around one call after the flush: host-inclusive), ``host_us`` per
    wrapper call, and, unless ``plain`` is None, ``plain_ms`` of its plain
    version (events, flushed)."""
    record["ms"] = device_ms(kernel, name)
    record["graph_ms"] = graph_ms(kernel)
    record["event_ms"] = cuda_ms(kernel, flush=True)
    record["host_us"] = host_us(kernel)
    if plain is not None:
        record["plain_ms"] = cuda_ms(plain, reps=plain_reps, flush=True)


def profile_plan(bench, cfg):
    """``gn.plan(*bench, cfg)`` under :func:`profile_run`."""
    from dgpmp2_tpu_torch.core import gn

    return profile_run(lambda: gn.plan(*bench, cfg))


def profile_run(run):
    """``run()`` once under ``torch.profiler``, after a warm-up: the
    profiler, and a record of the wall ms, the device-busy ms, the device
    operations and, for each of the port's kernels that ran, its launches,
    device µs per launch and share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an op's row repeats the device time of its kernels.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows)
    rec = {"wall_ms": wall, "busy_ms": busy / 1e3,
           "ops": sum(e.count for e in rows)}
    for name in KERNELS:
        mine = [e for e in rows if f"{name}_kernel" in e.key]
        n = sum(e.count for e in mine)
        if n:
            us = sum(e.self_device_time_total for e in mine)
            rec[name] = {"launches": n, "us": us / n,
                         "share": us / max(busy, 1e-9)}
    return prof, rec


def times_line(rec):
    """One line of a kernel's times from :func:`kernel_ms` and its bound."""
    return (f"device-only {rec['ms']:.4f} ms (profiler, L2 flushed), CUDA "
            f"graph {rec['graph_ms']:.4f} ms (warm L2), host-inclusive "
            f"events {rec['event_ms']:.4f} ms, host {rec['host_us']:.1f} µs "
            f"per launch() call; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), share of bound "
            f"{rec['bound_ms'] / rec['ms']:.4f}; plain {rec['plain_ms']:.4f} "
            f"ms")


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


def bench3d_inputs(b: int, dev, seed: int = 0, vox: int = VOX):
    """benchmarks/bench_throughput.py:109-146's 3-D worlds, carved on
    ``dev``: one 12^3 box per 64^3 occupancy grid (uint8, 1 = free), starts
    near (-4, -4, -4) and goals near (4, 4, 4); at another ``vox`` the box
    and its placement scale with the grid."""
    rng = np.random.default_rng(seed)
    edge = 12 * vox // 64
    r = torch.tensor(rng.integers(10 * vox // 64, vox - 22 * vox // 64,
                                  (b, 3)), device=dev)
    start = np.zeros((b, 6))
    start[:, :3] = rng.uniform(-4.5, -3.5, (b, 3))
    goal = np.zeros((b, 6))
    goal[:, :3] = rng.uniform(3.5, 4.5, (b, 3))
    ax = torch.arange(vox, device=dev)
    inside = [(ax >= r[:, i:i + 1]) & (ax < r[:, i:i + 1] + edge)
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


def golden_errors(out, g, prefix="") -> dict:
    """Relative max-abs errors of the port's plan against the golden."""
    def err(name, ref):
        ref = torch.tensor(ref)
        return rel_err(getattr(out, name).detach().cpu(), ref)

    return {k: err(k, g[prefix + k]) for k in
            ("th", "err_init", "err_per_iter", "err_ext_per_iter")}


def golden_ext_problem(dev, case, g, dtype=torch.float64):
    """One case of the constrained golden on ``dev``: (planner, params, th0,
    sdf), the planner a ``DiffGPMP2Planner`` of the stored YAML-schema
    config and the params with the workspace goal where the case has one."""
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    cfg = json.loads(str(g[f"{case}_config"]))
    planner = DiffGPMP2Planner(
        cfg["gp"], cfg["obs"], cfg["planner"],
        {"method": cfg["method"], "reg": cfg["reg"],
         "max_iters": cfg["iters"], "tol_delta": 0.0},
        cfg["env"], make_robot(cfg["robot"]), dtype=dtype, device=dev)
    params = planner.make_params(g[f"{case}_start"], g[f"{case}_goal"],
                                 workspace_goal=g.get(f"{case}_workspace_goal"))
    return (planner, params,
            torch.tensor(g[f"{case}_th0"], dtype=dtype, device=dev),
            occupancy_sdf(g[f"{case}_images"], dev, dtype))


def golden_ext_plan(dev, case, g):
    """Plan one case of the constrained golden in float64 on ``dev`` as the
    JAX package did: ``DiffGPMP2Planner.plan``, or ``gn.plan`` of its spec
    with the workspace-goal params."""
    from dgpmp2_tpu_torch.core import gn

    planner, params, th0, sdf = golden_ext_problem(dev, case, g)
    if params.p_goal is None:
        return planner.plan(th0, g[f"{case}_start"], g[f"{case}_goal"], sdf)
    return gn.plan(planner.spec, planner.robot, params, th0, sdf, planner.cfg)


def learned_golden_plan(dev, case, g):
    """Plan one case of the learned golden in float64 on ``dev``: the
    weights remade from the stored seed and flax tree shapes about the
    head's static init, as the JAX package's were.  Returns ``(th, errs,
    errs_ext)``."""
    from dgpmp2_tpu_torch import convert
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.learn.learned_planner import (
        LearnedDiffGPMP2Planner, LearnedPlannerConfig)

    cfg = json.loads(str(g[f"{case}_config"]))
    lkw = dict(cfg["learn"], static_init=tuple(cfg["learn"]["static_init"]))
    spec, robot, params, th0, sdf = port_problem(
        g[f"{case}_images"], g[f"{case}_start"], g[f"{case}_goal"], dev,
        torch.float64, cfg["T"], cfg["cost_sigma"], cfg["epsilon_dist"],
        cfg["k_s"], cfg["k_g"])
    planner = LearnedDiffGPMP2Planner(
        spec, robot, gn.OptimConfig(reg=cfg["reg"], max_iters=cfg["iters"],
                                    method=cfg["method"]),
        LearnedPlannerConfig(**lkw, dtype=torch.float64), device=dev)
    im = torch.tensor(g[f"{case}_images"], dtype=torch.float64, device=dev)
    shapes = json.loads(str(g[f"{case}_shapes"]))
    tree = convert.seeded_flax_tree(shapes, int(g[f"{case}_seed"]),
                                    convert.learned_out_path(shapes),
                                    planner.out_bias)
    variables = planner.load_variables(convert.learned_state_from_flax(tree),
                                       planner.stack_inputs(im, sdf), th0)
    with torch.no_grad():
        th, errs, errs_ext, _ = planner.plan(variables, params, th0, sdf, im,
                                             track_best=cfg["track_best"])
    return th, errs, errs_ext


def learned_golden_errors(dev, path=GOLDEN_LEARNED) -> dict:
    """case -> relative max-abs errors of the port's learned plans against
    the learned golden."""
    g = dict(np.load(path))
    out = {}
    for case in g["cases"]:
        got = learned_golden_plan(dev, case, g)
        out[str(case)] = {
            name: rel_err(x.detach().cpu(), torch.tensor(g[f"{case}_{name}"]))
            for name, x in zip(("th", "errs", "errs_ext"), got)}
    return out


def spd_system(rng, b, t, d, dtype, dev):
    """Block-diagonally dominant SPD system: off blocks N(0, s²) with
    s = 0.3 up to D = 16 and 0.3·(16/D)^½ above (the norm of an off block
    grows as D^½; this keeps it at D = 16's), diag G Gᵀ/10 + 4I, so every
    Schur pivot stays far from singular.  Drawn in float64 on ``dev`` by a
    generator seeded from ``rng`` (numpy would take minutes at B = 4096,
    D = 32)."""
    gen = torch.Generator(dev).manual_seed(int(rng.integers(2 ** 62)))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=dev)

    g = normal(b, t, d, d)
    diag = g @ g.transpose(-1, -2) * 0.1 + 4.0 * torch.eye(
        d, dtype=torch.float64, device=dev)
    off = 0.3 * min(1.0, (16 / d) ** 0.5) * normal(b, t - 1, d, d)
    return [a.to(dtype) for a in (diag, off, normal(b, t, d))]


BTD_D = tuple(range(1, 33))  # every D of the narrow and the wide kernel
BTD_NARROW = 16  # D = 1-16: one instance each; D = 17-32: the wide kernel
# Past D = 32, the block kernel: arms of 17, 20, 24 and 32 links, then the
# largest D whose rows fit the card's shared memory and the next (global
# scratch rows), found from the kernel library at run time.
BTD_BLOCK_D = (33, 40, 48, 64)
# Ragged and edge shapes: a lone problem, a batch that leaves the last warp
# partly empty, the multistart pool; one block solve, one Schur step, the
# arm's T.
BTD_EDGES = tuple((b, t) for b in (1, 1000, 4096) for t in (1, 2, 41))
# K-BTD timed at the shapes of the paths: (label, B, T+1, D, dtype).
BTD_TIMED = (("2-D", B, T + 1, 4, torch.float32),
             ("3-D and heading robot", B, T + 1, 6, torch.float32),
             ("multistart pool", 4 * B, T + 1, 4, torch.float32),
             ("plan_batch", 256, T + 1, 4, torch.float64),
             ("4-link arm", B, 41, 8, torch.float32))
# The wide kernel at the arms' T: a 9-link arm (D=18) and D=32.
BTD_WIDE_TIMED = tuple((f"D={d} arm", B, 41, d, dtype) for d in (18, 32)
                       for dtype in (torch.float32, torch.float64))
# NVIDIA's H100 SXM data sheet: HBM3 rate, and the dense rates outside the
# tensor cores (float32 67 TFLOP/s, float64 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def btd_bound(b, t, d, dtype):
    """K-BTD reads diag, off and rhs once and writes x once; per step and
    problem it does the Schur product (2D³ + 2D²), Gauss-Jordan on the
    D x (2D+1) rows (D²(3D+1)) and, in the back sweep, a matvec (2D²)."""
    sz = torch.finfo(dtype).bits // 8
    nbytes = sz * (b * t * d * d + b * (t - 1) * d * d + 2 * b * t * d)
    flops = b * (t * (2 * d ** 3 + 2 * d * d + d * d * (3 * d + 1))
                 + (t - 1) * 2 * d * d)
    return bound(nbytes, flops, dtype)


def dense_lambda(diag, off):
    """The dense (B, T·D, T·D) Λ of the block-tridiagonal storage."""
    b, t, d, _ = diag.shape
    lam = diag.new_zeros((b, t, d, t, d))
    i = torch.arange(t, device=diag.device)
    lam[:, i, :, i, :] = diag.transpose(0, 1)
    lam[:, i[:-1], :, i[1:], :] = off.transpose(0, 1)
    lam[:, i[1:], :, i[:-1], :] = off.transpose(-1, -2).transpose(0, 1)
    return lam.reshape(b, t * d, t * d)


def btd_err(k, diag, off, rhs):
    from dgpmp2_tpu_torch.ops import tridiag

    x_k = k.launch(diag, off, rhs)
    x_p = tridiag.btd_solve(diag, off, rhs)
    return rel_err(x_k, x_p), float((x_k - x_p).abs().max())


def check_btd(dev, record, bench, smi):
    """K-BTD against its plain version at every D it takes, at the paths'
    B=1024, T=101 and at the edge shapes; on the bench problem's own
    system; then timed at the paths' shapes beside its bound, its plain
    version and torch.linalg.solve on the dense Λ."""
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    rng = np.random.default_rng(1)
    # Tolerances on well-conditioned systems: the kernel (Gauss-Jordan on
    # each pivot) and cuSOLVER's batched Cholesky round in different orders,
    # and both stay within a few hundred ulp of the exact solution.
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for d in BTD_D:
            # D > 8 (arms of 5+ links) at the arms' T = 41.
            t = T + 1 if d <= 8 else 41
            err, abs_err = btd_err(k, *spd_system(rng, B, t, d, dtype, dev))
            edge = max(btd_err(k, *spd_system(rng, b, te, d, dtype, dev))[0]
                       for b, te in BTD_EDGES)
            print(f"K-BTD random SPD {dtype} D={d}: max rel err vs plain "
                  f"{err:.3e} at B={B} T={t}, {edge:.3e} over B, T in "
                  f"{BTD_EDGES} (tol {tol:g})")
            if not (err <= tol and edge <= tol):
                raise AssertionError(f"K-BTD {dtype} D={d}: {err}, {edge}")
            if dtype == torch.float32 and d == 4:
                record["max_abs_err"] = abs_err
    check_btd_bench_system("bench system", bench)
    for label, b, t, d, dtype in BTD_TIMED + BTD_WIDE_TIMED:
        diag, off, rhs = spd_system(rng, b, t, d, dtype, dev)

        def kern():
            return k.launch(diag, off, rhs)

        def plain():
            return tridiag.btd_solve(diag, off, rhs)

        rec = {}
        kernel_ms(rec, kern, plain, "btd_solve_kernel",
                  plain_reps=5 if label == "2-D" else 3)
        rec["bound_ms"], rec["bound_by"] = btd_bound(b, t, d, dtype)
        line = f"[{smi}] K-BTD {label} B={b} T={t} D={d} {dtype}: {times_line(rec)}"
        if d <= 8:
            lam, r = dense_lambda(diag, off), rhs.reshape(b, t * d, 1)
            rec["library_ms"] = cuda_ms(lambda: torch.linalg.solve(lam, r),
                                        reps=3, warmup=1)
            del lam
            line += (f"; torch.linalg.solve on the dense (B, T·D, T·D) Λ "
                     f"{rec['library_ms']:.4f} ms")
        else:
            # The dense Λ would take b·(T·D)²·itemsize: 7 GB at D=32 in f32.
            line += "; torch.linalg.solve on the dense Λ not measured"
        print(line)
        if label == "2-D":
            record.update(rec)
    check_btd_block(dev, smi, rng)


def btd_smem_max(k, dev):
    """The largest D whose block-kernel rows fit the card's shared memory."""
    d = BTD_D[-1] + 1
    while k.scratch_bytes(d + 1, dev) == 0:
        d += 1
    return d


def check_btd_block(dev, smi, rng):
    """K-BTD past D = 32 (the block kernel) against its plain version at
    B=1024, T=41 in both dtypes, at BTD_BLOCK_D and the shared-memory limit
    and one above it, each timed beside its bound.  Tolerance, relative to
    the plain version: 1e-13 in float64, 1e-6 in float32 (the kernel works
    in float64 there; both are also held against the float64 solve)."""
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    t = 41
    top = btd_smem_max(k, dev)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
        for d in BTD_BLOCK_D + (top, top + 1):
            system = spd_system(rng, B, t, d, dtype, dev)
            x_k = k.launch(*system)
            x_p = tridiag.btd_solve(*system)
            err = rel_err(x_k, x_p)
            extra = ""
            if dtype == torch.float32:
                x64 = tridiag.btd_solve(*(a.double() for a in system))
                e_k, e_p = rel_err(x_k.double(), x64), rel_err(x_p.double(), x64)
                extra = (f"; against the float64 solve: kernel {e_k:.3e}, "
                         f"plain {e_p:.3e}")
                del x64
            where = ("global scratch" if k.scratch_bytes(d, dev)
                     else "shared memory")
            print(f"K-BTD block D={d} {dtype} B={B} T={t} (rows in {where}): "
                  f"max rel err vs plain {err:.3e} (tol {tol:g}){extra}")
            if not err <= tol:
                raise AssertionError(f"K-BTD block {dtype} D={d}: {err}")
            ms = device_ms(lambda: k.launch(*system), "btd_solve_kernel",
                           reps=3)
            plain = cuda_ms(lambda: tridiag.btd_solve(*system), reps=2,
                            warmup=1)
            bms, by = btd_bound(B, t, d, dtype)
            print(f"[{smi}] K-BTD block D={d} B={B} T={t} {dtype}: "
                  f"device-only {ms:.4f} ms (profiler, L2 flushed); bound "
                  f"{bms:.4f} ms ({by}), share of bound {bms / ms:.4f}; "
                  f"plain {plain:.4f} ms")
            del system, x_k, x_p


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


# Lookup tolerance.  The lookup kernels round as their plain versions do
# (correctly rounded coordinates, no fused multiply-add; K-LOOKUP-LIMB sums a
# tap's limbs in order), so they are held bit-equal: tolerance 0.
EXACT = (0.0, 0.0)
LOOKUP_DTYPES = (torch.float32, torch.float64)
# Shapes that exercise the lookup kernels' tiles of 128 points: B·P below
# one tile, exactly one tile, a ragged tail, P = 1, B = 1, P = 401; then the
# paths' shapes of more than one wave of blocks: the 2-link arm, GP
# interpolation and the multistart pool.
LOOKUP_EDGES = ((1, 50), (2, 64), (3, 101), (1024, 1), (1, 1), (7, 401),
                (1024, 246), (1024, 401), (4096, 101))


def compare(name, got, want, tol_d, tol_g, quiet=False):
    ed = float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0
    eg = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
    if not quiet:
        print(f"{name}: max abs err d {ed:.3e} (tol {tol_d:g}), grad "
              f"{eg:.3e} (tol {tol_g:g})")
    if not (ed <= tol_d and eg <= tol_g):
        raise AssertionError(f"{name}: {ed}, {eg}")
    return max(ed, eg)


def lookup_points(rng, p, ndim, b=B):
    """(b, p, ndim) query points: random in the world, one in ten outside
    it, some exactly on its border."""
    pts = rng.uniform(-4.99, 4.99, (b, p, ndim))
    pts[:, ::10] = rng.uniform(-7.0, 7.0, (b, len(range(0, p, 10)), ndim))
    pts[:, 1 % p, 0] = -5.0
    pts[:, 2 % p, 1] = 5.0
    return pts


def lookup_bound(points, ndim, taps, tap_bytes, dtype):
    """bound_ms, bound_by and library_ms of a lookup of ``points`` points:
    each reads its coordinates and its ``taps`` SDF taps and writes the
    value and the gradient (a few flops a point: bytes bound it).  No
    single PyTorch call returns the value and its gradient, so there is no
    library time."""
    sz = torch.finfo(dtype).bits // 8
    nbytes = points * (ndim * sz + taps * tap_bytes + (1 + ndim) * sz)
    ms, by = bound(nbytes, points * 2 * (1 + ndim) * taps, dtype)
    return {"bound_ms": ms, "bound_by": by, "library_ms": None}


def check_lookup_edges(name, k, entry, plain, ndim, dev, rng):
    """A lookup kernel against its plain version, bit-equal, at
    LOOKUP_EDGES in both dtypes and both OOB modes (points inside, outside
    and far outside the grid), and on points that start off the 16-byte
    grid, through ``entry`` (the differentiable call) and ``launch``."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    # A 16 x 12 x 20 voxel grid at res 0.5 spans z 8 m, y 6 m, x 10 m.
    grid, res, lims = (((32, 32), 10.0 / 32, (LIMS, LIMS)) if ndim == 2 else
                       ((16, 12, 20), 0.5, (LIMS, (-3.0, 3.0), (-4.0, 4.0))))
    worst = 0.0
    for dtype in LOOKUP_DTYPES:
        for b, p in LOOKUP_EDGES:
            sdf = torch.tensor(rng.standard_normal((b, *grid)), dtype=dtype,
                               device=dev)
            pts = lookup_points(rng, p, ndim, b)
            pts[0, 0] = 1e10
            pts_t = torch.tensor(pts, dtype=dtype, device=dev)
            for mode in sdf_ops.OOB_MODES:
                args = (sdf, pts_t, res, *lims, mode)
                worst = max(worst, compare(
                    f"{name} {dtype} {mode} B={b} P={p}", k.launch(*args),
                    plain(*args), *EXACT, quiet=True))
        flat = torch.tensor(rng.uniform(-4.9, 4.9, 3 * 101 * ndim + 1),
                            dtype=dtype, device=dev)
        odd = flat[1:].view(3, 101, ndim)
        assert odd.data_ptr() % 16
        sdf = torch.tensor(rng.standard_normal((3, *grid)), dtype=dtype,
                           device=dev)
        want = plain(sdf, odd, res, *lims, "intended")
        for call in (entry, k.launch):
            worst = max(worst, compare(
                f"{name} {dtype} misaligned view",
                call(sdf, odd, res, *lims, "intended"), want, *EXACT,
                quiet=True))
    print(f"{name} at (B, P) in {LOOKUP_EDGES} and on a view off the 16-byte "
          f"grid, float32 and float64, both OOB modes: max abs err "
          f"{worst:.3e} (tol 0)")


def path_lookups(dev):
    """name -> (sdf, points, res, x_lims, y_lims[, z_lims]): the lookup that
    each path's ``graph.eval_residuals`` makes at its straight-line seed
    (2-D bench, 2-link arm P=246, GP interpolation P=401, multistart pool
    B=4096, ``plan_batch`` float64 B=256, 3-D bench), recorded at
    ``ops.sdf.lookup_nd``; then uniform random 2-D points, 3-D
    ``trajectory_points`` and one point of each (the fixed cost of a
    launch)."""
    from dgpmp2_tpu_torch.core import graph
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    seen = []
    entry = sdf_ops.lookup_nd

    def record(sdf, points, res, x_lims, y_lims, z_lims=None):
        lims = (tuple(x_lims), tuple(y_lims))
        if z_lims is not None:
            lims += (tuple(z_lims),)
        seen.append((sdf.contiguous(), points.contiguous(), float(res),
                     *lims))
        return entry(sdf, points, res, x_lims, y_lims, z_lims)

    bench_np = bench_inputs(B)
    problems = {"2-D bench plan points": lambda: port_problem(
        *bench_np, dev, torch.float32)}
    constrained = constrained_problems(dev, bench_np)
    for name, key in (("2-link arm P=246", "2-link arm"),
                      ("GP interpolation P=401",
                       "GP interpolation + velocity limits")):
        problems[name] = lambda key=key: problem_of(*constrained[key])
    problems["multistart pool B=4096"] = lambda: port_problem(
        *bench_inputs(4 * B), dev, torch.float32)
    problems["plan_batch float64 B=256"] = lambda: port_problem(
        *bench_inputs(256), dev, torch.float64)
    problems["3-D bench plan points"] = lambda: port_problem(
        *bench3d_inputs(B, dev), dev, torch.float32)
    out = {}
    sdf_ops.lookup_nd = record
    try:
        for name, make in problems.items():
            graph.eval_residuals(*make())
            out[name] = seen.pop()
            seen.clear()
    finally:
        sdf_ops.lookup_nd = entry
    rng = np.random.default_rng(2)
    sdf2, _, res2, xl, yl = out["2-D bench plan points"]
    pts = torch.tensor(lookup_points(rng, T + 1, 2, B), dtype=torch.float32,
                       device=dev)
    out["2-D uniform random points"] = (sdf2, pts, res2, xl, yl)
    sdf3 = out["3-D bench plan points"][0]
    pts3 = torch.tensor(trajectory_points(rng, B, T + 1), dtype=torch.float32,
                        device=dev)
    out["3-D trajectory_points"] = (sdf3, pts3, 10.0 / VOX, LIMS, LIMS, LIMS)
    out["2-D one point"] = (sdf2[:1], pts[:1, :1].contiguous(), res2, xl, yl)
    out["3-D one point"] = (sdf3[:1], pts3[:1, :1].contiguous(), 10.0 / VOX,
                            LIMS, LIMS, LIMS)
    return out


def check_path_lookups(lookups):
    """K-LOOKUP and K-LOOKUP3D bit-equal to their plain versions on the
    lookup each path makes (:func:`path_lookups`), in both OOB modes, in the
    path's dtype and the other one."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup, sdf_lookup3d

    worst = 0.0
    for name, (sdf, pts, *rest) in lookups.items():
        k, plain = ((sdf_lookup, sdf_ops.bilinear_lookup) if len(rest) == 3
                    else (sdf_lookup3d, sdf_ops.trilinear_lookup))
        other = (torch.float64 if sdf.dtype == torch.float32
                 else torch.float32)
        for s, p in ((sdf, pts), (sdf.to(other), pts.to(other))):
            for mode in sdf_ops.OOB_MODES:
                args = (s, p, *rest, mode)
                worst = max(worst, compare(f"{name} {s.dtype} {mode}",
                                           k.launch(*args), plain(*args),
                                           *EXACT, quiet=True))
    print(f"K-LOOKUP and K-LOOKUP3D on each path's own lookup "
          f"({', '.join(lookups)}), float32 and float64, both OOB modes: "
          f"max abs err {worst:.3e} (tol 0)")


def check_lookup(dev, record, bench, smi):
    """K-LOOKUP bit-equal to its plain version on random SDFs at B=1024,
    P=101 (far out-of-grid points too) and at the edge shapes; timed on the
    bench plan's own points (the FK centres of its straight-line seed) and
    on uniform random points."""
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
    for dtype in LOOKUP_DTYPES:
        sdf = torch.tensor(rng.standard_normal((B, IMSIZE, IMSIZE)),
                           dtype=dtype, device=dev)
        p_t = torch.tensor(pts, dtype=dtype, device=dev)
        for mode in sdf_ops.OOB_MODES:
            compare(f"K-LOOKUP {dtype} {mode}",
                    k.launch(sdf, p_t, res, LIMS, LIMS, mode),
                    sdf_ops.bilinear_lookup(sdf, p_t, res, LIMS, LIMS, mode),
                    *EXACT)
    check_lookup_edges("K-LOOKUP", k, k.bilinear_lookup_cuda,
                       sdf_ops.bilinear_lookup, 2, dev, rng)
    spec, robot, _, th0, bench_sdf = bench
    bench_sdf = bench_sdf.contiguous()
    centres = robot.fk(th0)[0].reshape(B, -1, 2).contiguous()
    for label, p_t in (("the bench plan's points", centres),
                       ("uniform random points", p_t)):
        args = (bench_sdf, p_t.float(), res, LIMS, LIMS, "intended")
        rec = {}
        err = compare(f"K-LOOKUP on {label}", k.launch(*args),
                      sdf_ops.bilinear_lookup(*args), *EXACT)
        kernel_ms(rec, lambda: k.launch(*args),
                  lambda: sdf_ops.bilinear_lookup(*args), "sdf_lookup_kernel")
        rec.update(lookup_bound(B * (T + 1), 2, 4, 4, torch.float32))
        print(f"[{smi}] K-LOOKUP B={B} P={T + 1} float32 on {label}: "
              f"{times_line(rec)}")
        if not record.get("ms"):
            record.update(rec, max_abs_err=err)


def trajectory_points(rng, b, p, noise=0.1):
    """(b, p, 3) points along straight start -> goal paths with noise: the
    access pattern of a plan's states."""
    t = np.linspace(0.0, 1.0, p)[None, :, None]
    s = rng.uniform(-4.5, -3.5, (b, 1, 3))
    g = rng.uniform(3.5, 4.5, (b, 1, 3))
    return s + t * (g - s) + noise * rng.standard_normal((b, p, 3))


def check_lookup3d(dev, record, smi):
    """K-LOOKUP3D bit-equal to its plain version at B=1024, 64^3, P=101 on
    trajectory points (corners, faces and far points too) and at the edge
    shapes; timed on the trajectory points."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as k

    rng = np.random.default_rng(3)
    res = 10.0 / VOX
    p = T + 1
    clean = trajectory_points(rng, B, p)
    pts = clean.copy()
    pts[:, ::10] = rng.uniform(-7.0, 7.0, (B, len(range(0, p, 10)), 3))
    pts[:, 1] = (-5.0, 5.0, 5.0)  # a corner of the world
    pts[:, 2, 2] = 5.0  # a face
    pts[:, 3] = (1e10, -1e10, 0.2)  # far outside the grid
    for dtype in LOOKUP_DTYPES:
        sdf = torch.randn((B, VOX, VOX, VOX), dtype=dtype, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
        p_t = torch.tensor(pts, dtype=dtype, device=dev)
        for mode in sdf_ops.OOB_MODES:
            args = (sdf, p_t, res, LIMS, LIMS, LIMS, mode)
            compare(f"K-LOOKUP3D {dtype} {mode}", k.launch(*args),
                    sdf_ops.trilinear_lookup(*args), *EXACT)
        if dtype == torch.float32:
            args = (sdf, torch.tensor(clean, dtype=dtype, device=dev), res,
                    LIMS, LIMS, LIMS, "intended")
            err = compare("K-LOOKUP3D on trajectory points", k.launch(*args),
                          sdf_ops.trilinear_lookup(*args), *EXACT)
            kernel_ms(record, lambda: k.launch(*args),
                      lambda: sdf_ops.trilinear_lookup(*args),
                      "sdf_lookup3d_kernel")
            record.update(lookup_bound(B * p, 3, 8, 4, dtype),
                          max_abs_err=err)
            print(f"[{smi}] K-LOOKUP3D B={B} P={p} 64^3 float32 on "
                  f"trajectory points: {times_line(record)}")
        del sdf, args
    check_lookup_edges("K-LOOKUP3D", k, k.trilinear_lookup_cuda,
                       sdf_ops.trilinear_lookup, 3, dev, rng)


# The 2-D paths' lookups on which K-LOOKUP-LIMB is checked and timed.
LIMB_SHAPES = ("2-D bench plan points", "2-D uniform random points",
               "2-link arm P=246", "multistart pool B=4096")


def check_limbs(dev, record, smi, lookups):
    """K-LOOKUP-LIMB bit-equal to its plain version, the packed layout's
    reader (itself bit-equal to ``bilinear_lookup_limbs`` on the (B, L, H,
    W) limbs), at L = 1, 2, 3 on the 2-D paths' lookups (LIMB_SHAPES) and
    at the tile edges (points far outside the grid and on its last cell
    too); timed at L = 1 on the bench plan's points, beside K-LOOKUP on the
    float32 SDF and the split of the SDF into its packed limbs."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k_exact
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as k

    def check(name, sdf, pts, res, xl, yl):
        worst = 0.0
        for n_limbs in (1, 2, 3):
            packed = k.split(sdf, n_limbs)
            args = (packed, pts, res, xl, yl)
            want = sdf_ops.bilinear_lookup_packed(*args)
            worst = max(worst, compare(
                f"{name} L={n_limbs}", k.launch(*args), want, *EXACT,
                quiet=True), compare(
                f"{name} L={n_limbs} plain", want,
                sdf_ops.bilinear_lookup_limbs(sdf_ops.limb_split(
                    sdf, n_limbs), pts, res, xl, yl), *EXACT, quiet=True))
        return worst

    worst = max(check(name, *lookups[name]) for name in LIMB_SHAPES)
    rng = np.random.default_rng(4)
    for b, p in LOOKUP_EDGES:
        pts = lookup_points(rng, p, 2, b)
        pts[0, 0] = 1e10
        pts[-1, -1] = (5.0 - 0.1, -5.0 + 0.1)  # the grid's last cell
        worst = max(worst, check(
            f"edges B={b} P={p}",
            torch.tensor(rng.standard_normal((b, 32, 32)),
                         dtype=torch.float32, device=dev),
            torch.tensor(pts, dtype=torch.float32, device=dev), 10.0 / 32,
            LIMS, LIMS))
    print(f"K-LOOKUP-LIMB at L = 1, 2, 3 on {', '.join(LIMB_SHAPES)} and at "
          f"(B, P) in {LOOKUP_EDGES}: max abs err {worst:.3e} (tol 0), "
          f"against the packed reader and bilinear_lookup_limbs")
    sdf, pts, res, xl, yl = lookups["2-D bench plan points"]
    packed = k.split(sdf, 1)
    args = (packed, pts, res, xl, yl)
    kernel_ms(record, lambda: k.launch(*args),
              lambda: sdf_ops.bilinear_lookup_packed(*args),
              "sdf_lookup_limbs_kernel")
    record.update(lookup_bound(pts.shape[0] * pts.shape[1], 2, 4, 2,
                               torch.float32), max_abs_err=worst)
    record["exact_ms"] = device_ms(
        lambda: k_exact.launch(sdf, pts, res, xl, yl), "sdf_lookup_kernel")
    splits = {n: cuda_ms(lambda n=n: k.split(sdf, n), reps=5)
              for n in (1, 2, 3)}
    print(f"[{smi}] K-LOOKUP-LIMB L=1 B={pts.shape[0]} P={pts.shape[1]} on "
          f"the bench plan's points: {times_line(record)}; K-LOOKUP "
          f"device-only {record['exact_ms']:.4f} ms on the same points; split "
          f"into the packed limbs, once per plan: "
          + ", ".join(f"L={n} {ms:.4f} ms" for n, ms in splits.items()))


def check_golden(dev):
    phase("4 float64 reference check (goldens from the JAX package)")
    # 1e-8: both sides are float64 solves of the same well-posed systems;
    # no hinge sits on its activation boundary in any of them.
    runs = [(path.name, *golden_plan(dev, path), "")
            for path in (GOLDEN, GOLDEN3D)]
    g = dict(np.load(GOLDEN_EXT))
    runs += [(f"{GOLDEN_EXT.name}:{case}", golden_ext_plan(dev, case, g), g,
              f"{case}_") for case in g["cases"]]
    checks = [(name, golden_errors(out, gold, prefix))
              for name, out, gold, prefix in runs]
    checks += [(f"{GOLDEN_LEARNED.name}:{case}", errs) for case, errs in
               learned_golden_errors(dev).items()]
    for name, errs in checks:
        print(f"{name} relative errors " + json.dumps(errs))
        bad = {k: v for k, v in errs.items() if not v <= 1e-8}
        if bad:
            raise AssertionError(f"{name} mismatch: {bad}")


def check_plan(name, out, n_iter, dof=2, t=T, share=0.95):
    """Shapes (B, t+1, 2·dof) and (n_iter, B), finite trajectories, and
    ``err_final < err_init`` on at least ``share`` of the problems."""
    shapes = (tuple(out.th.shape), tuple(out.err_per_iter.shape))
    if shapes != ((B, t + 1, 2 * dof), (n_iter, B)):
        raise AssertionError(f"{name}: shapes {shapes}")
    finite = bool(torch.isfinite(out.th).all())
    better = float((out.err_final < out.err_init).double().mean())
    print(f"{name}: finite {finite}, err_final < err_init on "
          f"{better:.4f} of problems, mean err {float(out.err_init.mean()):.4g}"
          f" -> {float(out.err_final.mean()):.4g}, iterations {n_iter}")
    if not (finite and better >= share):
        raise AssertionError(f"{name}: finite={finite} improved={better}")


def counters():
    """The kernel wrappers' modules, by kernel name (K-LOOKUP-LIMB's also
    counts its SDF splits)."""
    from dgpmp2_tpu_torch.ops.cuda import (btd_solve, sdf_lookup,
                                           sdf_lookup3d, sdf_lookup_bwd,
                                           sdf_lookup_limbs)

    return dict(zip(KERNELS, (btd_solve, sdf_lookup, sdf_lookup3d,
                              sdf_lookup_limbs, sdf_lookup_bwd)))


# Launches of every path run through drive(), by kernel: the kernels line.
TOTALS = dict.fromkeys(KERNELS, 0)


def drive(name, run, want):
    """Run one path with every launch counter, and K-LOOKUP-LIMB's count of
    SDF splits ("limb_splits"), set to 0 just before and read just after;
    the counts must equal ``want`` (absent keys: 0), or ``want(out)`` where
    the count depends on the path's output."""
    mods = counters()
    limbs = mods["sdf_lookup_limbs"]
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    limbs.splits = 0
    out = run()
    torch.cuda.synchronize()
    counts = {k: m.launches for k, m in mods.items()}
    counts["limb_splits"] = limbs.splits
    want = want(out) if callable(want) else want
    want = {k: want.get(k, 0) for k in counts}
    print(f"{name} launches {json.dumps(counts)}, expected {json.dumps(want)}")
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    for k in KERNELS:
        TOTALS[k] += counts[k]
    return out, counts


def load_yamls(plan_yaml, robot_yaml="robot_2d.yaml",
               env_yaml="env_2d_params.yaml"):
    """(world limits, planner, gp, obs, optim, robot dicts) of the repo's
    YAMLs."""
    from dgpmp2_tpu_torch.utils.config import load_params

    env, pp, gp, obs, opt, robot_data = load_params(
        CONFIGS / plan_yaml, CONFIGS / robot_yaml, CONFIGS / env_yaml)
    lims = {k: env[k] for k in ("x_lims", "y_lims", "z_lims") if k in env}
    return lims, pp, gp, obs, opt, robot_data


def planner_from_yaml(dim, dev):
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    lims, pp, gp, obs, opt, robot_data = load_yamls(
        f"gpmp2_{dim}_params.yaml", f"robot_{dim}.yaml",
        f"env_{dim}_params.yaml")
    return DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(robot_data),
                            dtype=torch.float32, device=dev)


def seeds(spec, start, goal, dev, dtype=torch.float32):
    """Straight-line seeds (b, T+1, D) on ``dev`` between (b, D) states."""
    from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

    s = torch.tensor(start[:, :spec.dof], dtype=dtype, device=dev)
    g = torch.tensor(goal[:, :spec.dof], dtype=dtype, device=dev)
    return straight_line_traj(s, g, spec.total_time_sec,
                              spec.total_time_step)


def occupancy_sdf(imgs, dev, dtype=torch.float32):
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    imgs = torch.as_tensor(imgs, device=dev)
    return sdf_ops.sdf_from_occupancy(imgs, res=10.0 / imgs.shape[-1],
                                      dtype=dtype).contiguous()


def joint_states(rng, b, dof, centre, spread):
    """(b, 2·dof) states at rest with joint angles ``centre ± spread``."""
    x = np.zeros((b, 2 * dof))
    x[:, :dof] = np.asarray(centre) + rng.uniform(-1, 1, (b, dof)) * spread
    return x


def taskspace_inputs(b, seed=0):
    """examples/arm_taskspace_example.py's problem, b times: its 96x96 world
    (one obstacle on the tip's sweep arc), starts near q = (-0.4, 0, 0) and
    tip targets near (2.6, 2.6) behind the obstacle."""
    rng = np.random.default_rng(seed)
    img = np.ones((b, 96, 96), np.uint8)
    img[:, 31:42, 79:90] = 0
    start = joint_states(rng, b, 3, (-0.4, 0.0, 0.0), (0.3, 0.2, 0.2))
    target = 2.6 + rng.uniform(-0.4, 0.4, (b, 2))
    return img, start, target


def forest_inputs(b, imsize=IMSIZE, seed=0):
    """benchmarks/bench_multistart.py's build: 24 small boxes per image
    (forest-like clutter), starts near (-4, -4) and goals near (4, 4)."""
    rng = np.random.default_rng(seed)
    imgs = np.ones((b, imsize, imsize), np.float32)
    for i in range(b):
        for _ in range(24):
            cy, cx = rng.integers(12, imsize - 16, 2)
            s = rng.integers(3, 7)
            imgs[i, cy:cy + s, cx:cx + s] = 0.0
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    return imgs, start, goal


def main_path(dev, bench_np):
    """Drive the port's 2-D entry points at B=1024; returns the float32
    bench problem."""
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
    bench, _ = drive("2-D path", run, {"btd_solve": n_p + n_g,
                                       "sdf_lookup": n_p + n_g + 2})
    check_plan("DiffGPMP2Planner.plan (YAML config)", outs["p"], n_p)
    check_plan("core.gn.plan (reg=0.1, 50 iterations)", outs["g"], n_g)
    return bench


def path3d(dev, smi):
    """The 3-D path at B=1024: SDFs built on the card, then both entry
    points; returns the float32 problem."""
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

    drive("3-D path", run, {"btd_solve": n_p + n_g,
                            "sdf_lookup3d": n_p + n_g + 2})
    check_plan("3-D DiffGPMP2Planner.plan (3-D YAMLs)", outs["p"], n_p, 3)
    check_plan("3-D core.gn.plan (reg=0.1, 50 iterations)", outs["g"], n_g, 3)
    check_btd_bench_system("3-D bench system", bench)
    return bench


def engines(bench):
    """The 2-D bench problem under the limb engine and the 'pallas' engine."""
    phase("7 2-D lookup engines (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    cfg = gn.OptimConfig(reg=0.1, max_iters=50, tol_delta=0.0)
    try:
        sdf_ops.set_lookup_method("pallas_v3_1")
        # One split of the SDF for the plan, one launch per lookup.
        out, _ = drive("pallas_v3_1", lambda: gn.plan(*bench, cfg), {
            "btd_solve": 50, "sdf_lookup_limbs": 51, "limb_splits": 1})
        check_plan("core.gn.plan under pallas_v3_1 (bf16 SDF)", out, 50)
        sdf_ops.set_lookup_method("pallas")
        cfg5 = gn.OptimConfig(reg=0.1, max_iters=5, tol_delta=0.0)
        drive("pallas", lambda: gn.plan(*bench, cfg5),
              {"btd_solve": 5, "sdf_lookup": 6})
    finally:
        sdf_ops.set_lookup_method("auto")


ARM_YAMLS = ("gpmp2_arm_params.yaml", "robot_arm.yaml")


def yaml_planner(dev, yamls, robot=None, pp=None, gp=None, obs=None,
                 opt=None):
    """A float32 DiffGPMP2Planner on ``dev`` from the YAMLs ``yamls`` with
    the ``robot`` dict (else the robot YAML's) and each section's
    overrides."""
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    lims, pp0, gp0, obs0, opt0, rd = load_yamls(*yamls)
    return DiffGPMP2Planner(
        dict(gp0, **(gp or {})), dict(obs0, **(obs or {})),
        dict(pp0, **(pp or {})), dict(opt0, **(opt or {})), lims,
        make_robot(robot or rd), dtype=torch.float32, device=dev)


def taskspace_planner(dev):
    """The task-space 3-link arm (workspace goal, self-collision, joint
    limits, D=6): the arm_taskspace_example.py problem with the arm YAMLs'
    remaining values, under LM: plain GN swings this arm by tens of radians
    in its first steps."""
    return yaml_planner(
        dev, ARM_YAMLS,
        {"type": "planar_arm", "link_lengths": [1.8, 1.4, 1.2],
         "spheres_per_link": 2, "sphere_radius": [0.25]},
        pp=dict(dof=3, state_dim=6, total_time_step=30,
                use_workspace_goal=True),
        gp=dict(Q_c_inv=np.eye(3), K_g=100.0, q_min=[-2.4] * 3,
                q_max=[2.4] * 3),
        obs=dict(epsilon_dist=0.25), opt=dict(method="lm"))


def constrained_problems(dev, bench_np):
    """The four constrained paths at B=1024 in float32, each a
    DiffGPMP2Planner from the YAMLs with its inputs: name -> (planner,
    start, goal, workspace goal or None, sdf)."""
    imgs, start2, goal2 = bench_np
    sdf = occupancy_sdf(imgs, dev)
    rng = np.random.default_rng(5)
    out = {}

    def planner(*args, **kw):
        return yaml_planner(dev, *args, **kw)

    # 2-link arm (self-collision, joint limits), the arm YAMLs as they are.
    out["2-link arm"] = (
        planner(ARM_YAMLS, None),
        joint_states(rng, B, 2, (-2.0, 0.0), 0.4),
        joint_states(rng, B, 2, (1.6, 0.0), 0.4), None, sdf)
    # Heading robot (nonholonomic, D=6): the XYH YAML, 3-dof robot.
    start6, goal6 = np.zeros((B, 6)), np.zeros((B, 6))
    start6[:, :2], goal6[:, :2] = start2[:, :2], goal2[:, :2]
    start6[:, 2] = goal6[:, 2] = 0.785
    out["heading robot"] = (
        planner(("gpmp2_xyh_params.yaml",), {"type": "point_robot", "dof": 3,
                                             "sphere_radius": [0.4]}),
        start6, goal6, None, sdf)
    # Task-space 3-link arm (workspace goal, self-collision, joint limits,
    # D=6), the arm_taskspace_example.py problem with the arm YAMLs'
    # remaining values, under LM: plain GN swings this arm by tens of
    # radians in its first steps.
    img96, start3, target = taskspace_inputs(B)
    out["task-space 3-link arm"] = (
        taskspace_planner(dev), start3, start3, target,
        occupancy_sdf(img96, dev))
    # The bench problem with GP interpolation (4T checks: 3 per segment,
    # P = 101 + 300 points in one lookup) and velocity limits.
    out["GP interpolation + velocity limits"] = (
        planner(("gpmp2_2d_params.yaml",), None,
                pp=dict(use_gp_inter=True, total_check_step=4 * T,
                        use_vel_limits=True)),
        start2, goal2, None, sdf)
    # 4-link arm (D=8): the arm YAMLs' weights (T=40, self-collision, joint
    # limits ±2.8) with four links of 1.2, 1.0, 0.8 and 0.6 m.
    out["4-link arm"] = (
        planner(ARM_YAMLS,
                {"type": "planar_arm", "link_lengths": [1.2, 1.0, 0.8, 0.6],
                 "spheres_per_link": 2, "sphere_radius": [0.25]},
                pp=dict(dof=4, state_dim=8),
                gp=dict(Q_c_inv=np.eye(4), q_min=[-2.8] * 4,
                        q_max=[2.8] * 4)),
        joint_states(rng, B, 4, (-2.0, 0.0, 0.0, 0.0), 0.4),
        joint_states(rng, B, 4, (1.6, 0.0, 0.0, 0.0), 0.4), None, sdf)
    # 5-link arm (D=10), as the 4-link one with links of 1.0, 0.9, 0.8, 0.6
    # and 0.5 m, 20 GN iterations.
    out["5-link arm"] = (
        planner(ARM_YAMLS,
                {"type": "planar_arm",
                 "link_lengths": [1.0, 0.9, 0.8, 0.6, 0.5],
                 "spheres_per_link": 2, "sphere_radius": [0.25]},
                pp=dict(dof=5, state_dim=10),
                gp=dict(Q_c_inv=np.eye(5), q_min=[-2.8] * 5, q_max=[2.8] * 5),
                opt=dict(max_iters=20)),
        joint_states(rng, B, 5, (-2.0, 0.0, 0.0, 0.0, 0.0), 0.4),
        joint_states(rng, B, 5, (1.6, 0.0, 0.0, 0.0, 0.0), 0.4), None, sdf)
    # 9-link arm (D=18, the wide K-BTD), 20 iterations: links of 0.6 down
    # to 0.3 m, 3.8 m in all as the 5-link arm; under LM, whose rejected
    # steps let every problem improve (under plain GN 2 of 1024 did not in
    # 20 iterations on the card).
    links = [0.6, 0.5, 0.5, 0.45, 0.4, 0.4, 0.35, 0.3, 0.3]
    out["9-link arm"] = (
        planner(ARM_YAMLS,
                {"type": "planar_arm", "link_lengths": links,
                 "spheres_per_link": 2, "sphere_radius": [0.25]},
                pp=dict(dof=9, state_dim=18),
                gp=dict(Q_c_inv=np.eye(9), q_min=[-2.8] * 9, q_max=[2.8] * 9),
                opt=dict(max_iters=20, method="lm")),
        joint_states(rng, B, 9, (-2.0,) + (0.0,) * 8, 0.4),
        joint_states(rng, B, 9, (1.6,) + (0.0,) * 8, 0.4), None, sdf)
    # 17-link arm (D=34, the block K-BTD), 20 LM iterations: the 9-link
    # arm's link profile resampled at 17 links and scaled to the same 3.8 m.
    links17 = np.interp(np.linspace(0, 8, 17), np.arange(9), links)
    links17 = (links17 * 3.8 / links17.sum()).tolist()
    out["17-link arm"] = (
        planner(ARM_YAMLS,
                {"type": "planar_arm", "link_lengths": links17,
                 "spheres_per_link": 2, "sphere_radius": [0.25]},
                pp=dict(dof=17, state_dim=34),
                gp=dict(Q_c_inv=np.eye(17), q_min=[-2.8] * 17,
                        q_max=[2.8] * 17),
                opt=dict(max_iters=20, method="lm")),
        joint_states(rng, B, 17, (-2.0,) + (0.0,) * 16, 0.4),
        joint_states(rng, B, 17, (1.6,) + (0.0,) * 16, 0.4), None, sdf)
    return out


def problem_of(planner, start, goal, wg, sdf):
    """(spec, robot, params, th0, sdf) of one constrained path."""
    dev = planner.device
    return (planner.spec, planner.robot,
            planner.make_params(start, goal, workspace_goal=wg),
            seeds(planner.spec, start, goal, dev), sdf)


def constrained(dev, bench_np):
    """The constrained robots at B=1024, float32, through DiffGPMP2Planner
    from the YAMLs (``plan``; under a workspace goal ``make_params`` with it
    and ``gn.plan``), then GPMP2Planner.plan_batch; returns the float32
    problems for the timing phase."""
    phase("8 constrained robots (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.planner import GPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    problems = {}
    for name, (planner, start, goal, wg, sdf) in constrained_problems(
            dev, bench_np).items():
        prob = problem_of(planner, start, goal, wg, sdf)
        spec, robot, params, th0, _ = prob
        n = planner.cfg.max_iters
        if wg is None:
            run = lambda: planner.plan(th0, start, goal, sdf)  # noqa: E731
        else:
            run = lambda: gn.plan(spec, robot, params, th0, sdf,  # noqa: E731
                                  planner.cfg)
        out, _ = drive(name, run, {"btd_solve": n, "sdf_lookup": n + 1})
        # The 9- and 17-link arms must improve every problem.
        check_plan(name, out, n, spec.dof, spec.total_time_step,
                   1.0 if name in ("9-link arm", "17-link arm") else 0.95)
        if spec.use_self_collision:
            print(f"{name}: D={spec.state_dim}, {spec.num_self_pairs} "
                  f"self-collision pairs")
        problems[name] = prob
        if wg is not None:
            centers, _ = robot.fk(out.th)
            tip_err = (centers[:, -1, -1] - params.p_goal).norm(dim=-1)
            print(f"{name}: tip within 0.1 m of its target on "
                  f"{float((tip_err < 0.1).double().mean()):.4f} of problems")
    if problems["GP interpolation + velocity limits"][0].num_inter != 3:
        raise AssertionError("GP interpolation: num_inter != 3")

    # GPMP2Planner.plan_batch, LM in float64 on 256 bench problems: one
    # solve and two lookups per host iteration, plus the initial lookup.
    imgs, start2, goal2 = bench_np
    lims, pp, gp, obs, _, rd = load_yamls("gpmp2_2d_params.yaml")
    classic = GPMP2Planner(gp, obs, pp, lims, make_robot(rd), device=dev)
    nb = 256
    sdf64 = occupancy_sdf(imgs[:nb], dev, torch.float64)
    th0 = seeds(classic.spec, start2[:nb], goal2[:nb], dev, torch.float64)
    optim = {"method": "lm", "max_iters": 50, "tol_delta": 1e-3,
             "plan_time": "inf"}
    res, _ = drive("GPMP2Planner.plan_batch (LM, float64)",
                   lambda: classic.plan_batch(start2[:nb], goal2[:nb], th0,
                                              sdf64, optim),
                   lambda r: {"btd_solve": len(r[3]),
                              "sdf_lookup": 2 * len(r[3]) + 1})
    th, err_init, err_final, err_per_iter, iters, secs = res
    better = float(np.mean(err_final < err_init))
    finite = bool(torch.isfinite(th).all())
    print(f"GPMP2Planner.plan_batch (LM, float64, B={nb}): finite {finite}, "
          f"err_final < err_init on {better:.4f} of problems, "
          f"{len(err_per_iter)} host iterations, max iters {int(iters.max())}"
          f", {secs:.3f} s")
    if tuple(th.shape) != (nb, T + 1, 4) or not (finite and better >= 0.95):
        raise AssertionError(f"plan_batch: {tuple(th.shape)} {better}")
    return problems


MS_B, MS_K, MS_SEEDS = 256, 16, 4
MS_OPTIM = {"reg": 0.1, "max_iters": 50}
MS_RUNS = {"full": {}, "staged": {"prune_iters": 10, "keep": 4}}


def multistart(dev):
    """benchmarks/bench_multistart.py's defaults through
    GPMP2Planner.plan_multistart in float32: full pool and staged, for
    seeds 0..MS_SEEDS-1 of the perturbation draws.  Staged must keep the
    full pool's contact-free count within 2 % of the problems, summed over
    the seeds: one seed's difference spreads by a few problems either way
    (in the JAX package too)."""
    phase(f"9 multistart (B={MS_B}, K={MS_K}, float32)")
    from dgpmp2_tpu_torch.planner import GPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    lims, pp, gp, obs, _, rd = load_yamls("gpmp2_2d_params.yaml")
    planner = GPMP2Planner(gp, obs, pp, lims, make_robot(rd),
                           dtype=torch.float32, device=dev)
    imgs, start, goal = forest_inputs(MS_B)
    sdf = occupancy_sdf(imgs, dev)
    th0 = seeds(planner.spec, start, goal, dev)

    def run(name, seed=0):
        return planner.plan_multistart(start, goal, th0, sdf, MS_OPTIM,
                                       restarts=MS_K, amp=2.0, seed=seed,
                                       **MS_RUNS[name])

    free = {name: [] for name in MS_RUNS}
    for seed in range(MS_SEEDS):
        for name, kw in MS_RUNS.items():
            # Full: one K·B plan (50 solves, 51 lookups) and one scoring
            # lookup; staged: phases of 10 and 40 iterations and two
            # scoring lookups.
            want = {"btd_solve": 50, "sdf_lookup": 54 if kw else 52}
            out, _ = drive(f"multistart {name} seed {seed}",
                           lambda: run(name, seed), want)
            pool = 2 * kw["keep"] if kw else MS_K
            shapes = [tuple(x.shape) for x in out]
            if (shapes != [(MS_B, T + 1, 4)] + [(MS_B,)] * 4
                    or not bool(torch.isfinite(out.th).all())
                    or not bool(((out.k_best >= 0)
                                 & (out.k_best < pool)).all())
                    or not bool((out.iters <= 50).all())):
                raise AssertionError(f"multistart {name}: {shapes}")
            free[name].append(int(out.contact_free.sum()))
            print(f"multistart {name} seed {seed}: contact-free "
                  f"{free[name][-1]}/{MS_B}, mean iterations of the winners "
                  f"{float(out.iters.double().mean()):.2f}")
    total = {name: sum(v) for name, v in free.items()}
    print(f"multistart contact-free over seeds 0..{MS_SEEDS - 1}: "
          f"{json.dumps(free)}, totals {json.dumps(total)} of "
          f"{MS_B * MS_SEEDS}")
    if total["staged"] < total["full"] - 0.02 * MS_B * MS_SEEDS:
        raise AssertionError(f"staged multistart lost coverage: {free}")
    return run


def iter_ms(run):
    """ms per GN iteration of ``run(n)``, a plan of n iterations:
    (200-iteration plan - 50-iteration plan) / 150, each the median of 5
    CUDA-event runs after one warm-up."""
    t50, t200 = (cuda_ms(lambda: run(n), reps=5, warmup=1) for n in (50, 200))
    return t50, t200, (t200 - t50) / 150.0


def plan_ms(bench):
    """ms per GN iteration of ``core.gn.plan`` (:func:`iter_ms`)."""
    from dgpmp2_tpu_torch.core import gn

    return iter_ms(lambda n: gn.plan(*bench, gn.OptimConfig(
        reg=0.1, max_iters=n, tol_delta=0.0)))


# The learned planner's 2-D configuration: tools/learned_campaign.py's
# eps_bounded (:111-114) on its make_planner defaults (:225-236), with the
# fixed covariances of its COV (:54).
EPS_BOUNDED = dict(dynamics_mode="diag_identity", learn_eps=True, eps_max=0.8,
                   static_init=(1.0, 0.01, 0.4), dropout_prob=0.1)
# Its GRU twin, eps_bounded_gru (:130-134), hidden width 64.
EPS_BOUNDED_GRU = dict(EPS_BOUNDED, model_type="rnn_gru", hidden_dim=64)
# tools/learn3d_campaign.py:170-176, the 3-D planner (LM): the static init
# at COV's cost_sigma 0.05 in place of its sweep winner.
LEARN3D = dict(dynamics_mode="diag_identity", learn_eps=True, eps_max=0.8,
               dropout_prob=0.1, static_init=(1.0, 0.05, 0.4))
LEARN3D_VOX, LEARN3D_T = 32, 20


def learned_setup(dev, occupancy, start, goal, lkw=EPS_BOUNDED,
                  method="gauss_newton", iters=50, t=T, dtype=torch.float32,
                  weights_seed=None):
    """A learned planner on a bench problem: ``(planner, variables,
    params_fix, th0, sdf, im)``; the SDFs built on ``dev`` from the
    occupancy (B, H, W) or (B, D, H, W), the fixed covariances the
    campaigns' COV.  The weights are the planner's own init from a seeded
    generator, or, with ``weights_seed``, random weights about the static
    init made with numpy (``convert.seeded_flax_tree``)."""
    from dgpmp2_tpu_torch import convert
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.learn.learned_planner import (
        LearnedDiffGPMP2Planner, LearnedPlannerConfig)

    spec, robot, params, th0, sdf = port_problem(occupancy, start, goal, dev,
                                                 dtype, t)
    planner = LearnedDiffGPMP2Planner(
        spec, robot, gn.OptimConfig(reg=0.1, max_iters=iters, method=method),
        LearnedPlannerConfig(**lkw, dtype=dtype), device=dev)
    im = torch.as_tensor(occupancy, device=dev).to(dtype)
    stack = planner.stack_inputs(im, sdf)
    variables = planner.init_variables(torch.Generator().manual_seed(0),
                                       stack, th0)
    if weights_seed is not None:
        shapes = convert.learned_flax_shapes(variables)
        tree = convert.seeded_flax_tree(shapes, weights_seed,
                                        convert.learned_out_path(shapes),
                                        planner.out_bias)
        variables = planner.load_variables(
            convert.learned_state_from_flax(tree), stack, th0)
    return planner, variables, params, th0, sdf, im


def timing(smi, bench, bench3, problems, ms_run):
    phase("10 timing")
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    per_iter = {}
    try:
        sdf_ops.set_lookup_method("pallas_v3_1")
        t50, t200, per_iter["_v3_1"] = plan_ms(bench)
    finally:
        sdf_ops.set_lookup_method("auto")
    print(f"[{smi}] core.gn.plan B=1024 T=100 128x128 float32 under "
          f"pallas_v3_1: 50 iterations {t50:.3f} ms, 200 iterations "
          f"{t200:.3f} ms, ms per GN iteration {per_iter['_v3_1']:.4f}")
    for key, name, prob in (
            ("", "core.gn.plan B=1024 T=100 128x128", bench),
            ("_3d", "3-D core.gn.plan B=1024 T=100 64^3", bench3),
            ("_arm2", "2-link arm core.gn.plan B=1024 T=40 128x128",
             problems["2-link arm"]),
            ("_xyh", "heading robot core.gn.plan B=1024 T=100 128x128",
             problems["heading robot"]),
            ("_arm4", "4-link arm core.gn.plan B=1024 T=40 128x128",
             problems["4-link arm"])):
        t50, t200, per_iter[key] = plan_ms(prob)
        print(f"[{smi}] {name} float32: 50 iterations {t50:.3f} ms, 200 "
              f"iterations {t200:.3f} ms, ms per GN iteration "
              f"{per_iter[key]:.4f}")
    for name in MS_RUNS:
        ms = cuda_ms(lambda: ms_run(name), reps=5, warmup=1)
        print(f"[{smi}] multistart_ms_b{MS_B}_k{MS_K}_{name} {ms:.3f}")
    planner, variables, params, th0, sdf, im = learned_setup(
        bench[3].device, *bench_inputs(B))

    def learned_run(n):
        with torch.no_grad():
            return planner.plan(variables, params, th0, sdf, im, max_iters=n,
                                track_best=True)

    t50, t200, per_iter["_learned"] = iter_ms(learned_run)
    stack = planner.stack_inputs(im, sdf)
    with torch.no_grad():
        enc = cuda_ms(lambda: planner.conv_features(variables, stack), reps=5)
    print(f"[{smi}] learned planner (eps_bounded, feed-forward, track_best) "
          f"B=1024 T=100 128x128 float32: 50 iterations {t50:.3f} ms, 200 "
          f"iterations {t200:.3f} ms, ms per GN iteration "
          f"{per_iter['_learned']:.4f}; encoder once per plan {enc:.4f} ms")
    return per_iter


def fixed_err(planner, params, th, sdf):
    """The graph error under the fixed covariances at ``th`` (B,)."""
    from dgpmp2_tpu_torch.core import graph

    with torch.no_grad():
        return graph.graph_error(planner.spec, planner.robot, params, th, sdf)


def check_learned_plan(name, planner, params, th0, sdf, out, n_iter, dof,
                       t, share=0.95):
    """Shapes, finite values, and the final iterate's error under the fixed
    covariances below the seed's on at least ``share`` of the problems."""
    th, errs, errs_ext, _, th_final = out
    b = th0.shape[0]
    shapes = (tuple(th.shape), tuple(errs.shape), tuple(errs_ext.shape))
    if shapes != ((b, t + 1, 2 * dof), (n_iter, b), (n_iter, b)):
        raise AssertionError(f"{name}: shapes {shapes}")
    finite = bool(torch.isfinite(th).all() & torch.isfinite(th_final).all()
                  & torch.isfinite(errs_ext).all())
    e0 = fixed_err(planner, params, th0, sdf)
    e1 = fixed_err(planner, params, th_final, sdf)
    better = float((e1 < e0).double().mean())
    print(f"{name}: finite {finite}, fixed-covariance error of the final "
          f"iterate below the seed's on {better:.4f} of problems, mean "
          f"{float(e0.mean()):.4g} -> {float(e1.mean()):.4g}, iterations "
          f"{n_iter}")
    if not (finite and better >= share):
        raise AssertionError(f"{name}: finite={finite} improved={better}")


def learned(dev, bench_np):
    """The learned planner at full width in float32 (phase 11), each path
    through drive() with exact launch counts: one K-BTD launch per
    iteration, one lookup per iteration plus one at the seed (LM or
    track_best), one more per multistart scoring; then the gradient check
    (:func:`learned_gradient`)."""
    phase("11 learned planner (B=1024, float32)")
    from dgpmp2_tpu_torch.core import gn

    n = 50

    def plan(setup, **kw):
        planner, variables, params, th0, sdf, im = setup
        with torch.no_grad():
            return planner.plan(variables, params, th0, sdf, im,
                                return_final=True, **kw)

    # 2-D, the campaign's configuration at its static init.
    ff = learned_setup(dev, *bench_np)
    out, _ = drive("learned 2-D feed-forward", lambda: plan(
        ff, track_best=True), {"btd_solve": n, "sdf_lookup": n + 1})
    check_learned_plan("learned 2-D feed-forward (eps_bounded, track_best)",
                       ff[0], *ff[2:5], out, n, 2, T)
    # At static init the head emits the static covariances: its first 5
    # iterations are core.gn.plan's with them (float32: 5 iterations only).
    planner, variables, params, th0, sdf, im = ff
    static = port_problem(*bench_np, dev, torch.float32, T, cost_sigma=0.01,
                          epsilon_dist=0.4)
    with torch.no_grad():
        th5, errs5, _, _ = planner.plan(variables, params, th0, sdf, im,
                                        max_iters=5)
        ref = gn.plan(*static, gn.OptimConfig(reg=0.1, max_iters=5,
                                              tol_delta=0.0))
    e_th = rel_err(th5, ref.th)
    e_err = rel_err(errs5[1:], ref.err_per_iter[:-1])
    print(f"learned 2-D at static init, 5 iterations against core.gn.plan "
          f"with the static covariances: th rel err {e_th:.3e}, err trace "
          f"{e_err:.3e} (tol 1e-4, float32)")
    if not (e_th <= 1e-4 and e_err <= 1e-4):
        raise AssertionError(f"learned static init: {e_th}, {e_err}")

    # 2-D, the GRU head with random weights about the static init.
    gru = learned_setup(dev, *bench_np, lkw=EPS_BOUNDED_GRU, weights_seed=5)
    out, _ = drive("learned 2-D GRU", lambda: plan(gru, track_best=True),
                   {"btd_solve": n, "sdf_lookup": n + 1})
    th, errs, errs_ext, hidden, th_final = out
    finite = all(bool(torch.isfinite(x).all())
                 for x in (th, errs, errs_ext, th_final, *hidden))
    print(f"learned 2-D GRU (random weights): shapes {tuple(th.shape)}, "
          f"{tuple(errs.shape)}, carry {tuple(hidden[0].shape)}; finite "
          f"{finite}")
    if not finite or tuple(th.shape) != (B, T + 1, 4):
        raise AssertionError("learned GRU: not finite or misshapen")
    del gru

    # 3-D: PointRobot3D in 32^3 voxel worlds built on the card, T=20, LM.
    occ, start, goal = bench3d_inputs(B, dev, vox=LEARN3D_VOX)
    p3 = learned_setup(dev, occ, start, goal, lkw=LEARN3D, method="lm",
                       t=LEARN3D_T)
    out, _ = drive("learned 3-D", lambda: plan(p3),
                   {"btd_solve": n, "sdf_lookup3d": n + 1})
    check_learned_plan("learned 3-D (ConvEncoder3D, 32^3, T=20, LM)",
                       p3[0], *p3[2:5], out, n, 3, LEARN3D_T)
    del p3, out

    # Multistart on the multistart problem: B=256, K=16, full and staged.
    imgs, mstart, mgoal = forest_inputs(MS_B)
    planner, variables, params, th0, sdf, im = learned_setup(
        dev, imgs, mstart, mgoal)
    for name, kw in MS_RUNS.items():
        def run():
            with torch.no_grad():
                return planner.plan_multistart(
                    variables, params, th0, sdf, im,
                    torch.Generator(dev).manual_seed(0), restarts=MS_K,
                    amp=2.0, **kw)

        res, _ = drive(f"learned multistart {name}", run, {
            "btd_solve": n, "sdf_lookup": n + (4 if kw else 2)})
        pool = 2 * kw["keep"] if kw else MS_K
        if (tuple(res.th.shape) != (MS_B, T + 1, 4)
                or not bool(torch.isfinite(res.th).all())
                or not bool(((res.k_best >= 0) & (res.k_best < pool)).all())):
            raise AssertionError(f"learned multistart {name}")
        print(f"learned multistart {name} (B={MS_B}, K={MS_K}): contact-free "
              f"{int(res.contact_free.sum())}/{MS_B}")
    learned_gradient(dev)


# Seeds of the gradient check through the float32 decode as shipped (each
# the seed of the inputs and of the weights); the float64-decode check takes
# the first.
GRAD_SEEDS = (3, 4, 5, 6)


def decode_in_float64(planner):
    """Make ``planner.predict`` decode the head's output in the plan's
    float64, where the package, as JAX, casts it to float32 first: the
    gradient and train-step checks of the kernel path, free of that cast's
    rounding."""
    from dgpmp2_tpu_torch.learn import covariances as cov_lib

    lc = planner.learn_cfg

    def predict(variables, th, feats, hidden=None, train=False,
                dth_prev=None, rng=None):
        pos = planner._head_pos(th, dth_prev)
        head = variables["head"]
        if planner.recurrent:
            out, hidden = head(feats, pos, hidden)
        else:
            out, hidden = head(feats, pos, train=train, rng=rng), None
        return cov_lib.decode(out, planner.spec, lc.dynamics_mode,
                              lc.learn_eps, lc.eps_max), hidden

    planner.predict = predict


def learned_gradient(dev, b=64, iters=5):
    """d(Σ err_ext)/d(every weight) of a float64 learned plan (B=64, 5
    iterations, random weights about the static init, learned eps decoded
    as s², GN) on the card, through K-BTD's adjoint launches and
    K-LOOKUP-BWD, against the same on the CPU with the plain versions,
    leaf by leaf: 1e-10 relative with the head's output decoded in float64
    (:func:`decode_in_float64`), which checks the kernel path; 1e-4 on each
    of ``GRAD_SEEDS`` through the float32 decode as shipped, whose rounding
    (and gp_q_inv's float32 backward, where the 12/dt³ and 6/dt² terms
    cancel) a 1e-16 difference upstream can flip on one device and not the
    other."""
    from dgpmp2_tpu_torch import convert

    lkw = dict(dynamics_mode="diag_identity", learn_eps=True,
               static_init=(1.0, 0.05, 0.4))
    runs = [(GRAD_SEEDS[0], "float64", 1e-10)]
    runs += [(seed, "float32", 1e-4) for seed in GRAD_SEEDS]
    for seed, decode, tol in runs:
        inputs = bench_inputs(b, seed=seed)
        grads = []  # the card's, then the CPU's
        for where in (dev, torch.device("cpu")):
            planner, variables, params, th0, sdf, im = learned_setup(
                where, *inputs, lkw=lkw, iters=iters, dtype=torch.float64,
                weights_seed=seed)
            if decode == "float64":
                decode_in_float64(planner)

            def run():
                _, _, errs_ext, _ = planner.plan(variables, params, th0, sdf,
                                                 im)
                errs_ext.sum().backward()

            if where.type == "cuda":
                # A forward solve per iteration and an adjoint one for each
                # but the last, whose step reaches no err_ext; a K-LOOKUP-BWD
                # launch for each lookup but the seed's, whose points carry
                # no gradient.
                drive(f"learned gradient (float64, B={b}, seed {seed}, "
                      f"{decode} decode)", run,
                      {"btd_solve": 2 * iters - 1, "sdf_lookup": iters,
                       "sdf_lookup_bwd": iters - 1})
            else:
                run()
            grads.append(_leaves(convert.learned_grads_to_flax(variables)))
        errs = {path: rel_err(torch.tensor(a), torch.tensor(c))
                for (path, a), (_, c) in zip(*grads)}
        worst = max(errs, key=errs.get)
        nonzero = sum(bool(np.any(a != 0)) for _, a in grads[0])
        print(f"learned gradient, seed {seed}, {decode} decode, on the card "
              f"against the CPU: {len(errs)} weight tensors ({nonzero} "
              f"nonzero), max rel err {errs[worst]:.3e} at {worst} (tol "
              f"{tol:g})")
        if not errs[worst] <= tol or nonzero != len(errs):
            raise AssertionError(f"learned gradient seed {seed} {decode}: "
                                 f"{errs[worst]}")


# -- phase 12: data generation -------------------------------------------------

GOLDEN_DATA = ROOT / "tests" / "goldens" / "torch_port_data_small.npz"
# The data golden's tolerances: the host's draws exactly (maps, starts,
# goals, the generator's state after), the SDFs and seeds to 1e-6, the
# float32 labels of a 5-iteration LM plan to 1e-4 absolute.
DATA_GOLDEN_TOL = {"maps": 0, "start": 0.0, "goal": 0.0, "sdf": 1e-6,
                   "th_init": 1e-6, "th_opt": 1e-4}
# tools/learned_campaign.py:54-55, :136-159: forest worlds at 128^2, T=100,
# 4 problems each, an LM expert of 60 iterations with track_best, COV.  The
# campaign writes 250 train and 40 test worlds; here TRAIN_ENVS (phase 13
# trains on them) and 16.
DATA_COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4,
                k_s=0.01, k_g=0.01)
DATA_PROBS, DATA_ITERS, DATA_TEST_ENVS = 4, 60, 16
# --rrtstar_init on forest: RRT* needs the safety clearance (eps + radius,
# 0.8 m) along its whole path, wider than forest's start/goal patches and
# many of its gaps, so most searches find nothing and a world is drawn ~25
# times before all 4 of its searches succeed (a CPU probe: 2 worlds in 50
# draws); the generator's default of 20 draws in a row would end the run.
RRT_ENVS, RRT_RETRIES = 2, 200
# tools/learn3d_campaign.py:55-59, :130-133: boxes3d at 32^3, T=20, an LM
# expert of 40 iterations, 4 problems a world; 60 + 16 worlds there, 16
# here.
DATA3D = dict(size=32, t=LEARN3D_T, max_iters=40, probs=4, envs=16)
# data.generate_im's CLI defaults (multi_obstacle, 128^2, 200 train + 50
# test), then data.generate_paths on its test split: random pairs, 2 a
# world, a GN expert of 60 iterations (its CLI defaults).
IM_TRAIN, IM_TEST, PATH_PROBS = 200, 50, 2
# data.sensitivity's CLI batch; core.seeds on 16 test problems into a K=16
# multistart pool (phase 9's optimiser and amplitude).
SWEEP_B, SEEDS_B, SEEDS_K = 16, 16, 16


@contextlib.contextmanager
def counting_plans():
    """Count the calls of ``core.gn.plan`` and their iterations while the
    block runs: the terms of the generators' launch formula."""
    from dgpmp2_tpu_torch.core import gn

    plan, rec = gn.plan, {"plans": 0, "iters": 0}

    def counted(spec, robot, params, th_init, sdf, cfg, *args, **kw):
        rec["plans"] += 1
        rec["iters"] += cfg.max_iters
        return plan(spec, robot, params, th_init, sdf, cfg, *args, **kw)

    gn.plan = counted
    try:
        yield rec
    finally:
        gn.plan = plan


def plan_counts(rec, lookup="sdf_lookup", after=1):
    """Launches of the counted plans: a K-BTD solve per iteration; a lookup
    at the seed and one at each iteration's proposal, and ``after`` more per
    plan once it ends (the re-validation of its labels, a multistart
    scoring, or ``learn.eval.evaluate_batch``'s two)."""
    return {"btd_solve": rec["iters"],
            lookup: rec["iters"] + rec["plans"] * (1 + after)}


def generation(name, smi, run, worlds=None, lookup="sdf_lookup", after=1):
    """``run()`` through :func:`drive` with every plan counted; prints its
    wall seconds per world (or per plan) and plans per accepted world.
    Returns (output, plan record)."""
    with counting_plans() as rec:
        t0 = time.perf_counter()
        out, _ = drive(name, run, lambda _: plan_counts(rec, lookup, after))
        wall = time.perf_counter() - t0
    if rec["plans"] == 0:
        raise AssertionError(f"{name}: no plan ran")
    per = (f"{wall / worlds:.4f} s per world, {rec['plans'] / worlds:.4f} "
           f"plans per accepted world" if worlds else
           f"{wall / rec['plans']:.4f} s per plan")
    print(f"[{smi}] {name}: {wall:.3f} s wall, {rec['plans']} plans of "
          f"{rec['iters'] // rec['plans']} iterations; {per}")
    return out, rec


def acceptance(name, stats, worlds, probs, rec):
    """The generator's own counts: world draws and fresh problems per
    accepted world and problem; its plans must be the counted ones."""
    if stats["plans"] != rec["plans"]:
        raise AssertionError(f"{name}: {stats} against {rec}")
    print(f"{name}: {stats['attempts']} world draws for {worlds} worlds "
          f"({worlds / stats['attempts']:.4f} accepted per draw), "
          f"{worlds * probs} of {stats['problems']} problems planned kept "
          f"({worlds * probs / stats['problems']:.4f} accepted per attempt)")


def revalidate(name, split, probs, ndim=2, worlds=None):
    """Every label of a split read back from disk: by the port's reader
    (``PlanningDataset``, or ``load_split3d`` in 3-D), or, with ``worlds``
    (a run that stopped at an unsolvable world), the files of its first
    ``worlds`` worlds; as many label files as worlds x problems, and the
    plain lookup on the CPU finds every state of every ``th_opt`` clear of
    the robot radius, the generator's own guarantee.  Returns the smallest
    clearance."""
    import yaml

    from dgpmp2_tpu_torch.data import dataset as ds
    from dgpmp2_tpu_torch.data.generate3d import load_split3d
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.robots import PointRobot2D

    labels = split / "opt_trajs_gpmp2"
    files = len(list(labels.glob("env_*_prob_*.npz")))
    if worlds is not None:
        rows = [(np.load(split / "im_sdf" / f"{e}_sdf.npy"),
                 np.load(labels / f"env_{e}_prob_{j}.npz")["th_opt"])
                for e in range(worlds) for j in range(probs)]
        sdf = np.stack([r[0] for r in rows]).astype(np.float32)
        th = np.stack([r[1] for r in rows])
    elif ndim == 2:
        worlds = yaml.safe_load((split / "meta.yaml").read_text())["num_envs"]
        items = ds.PlanningDataset(str(split.parent), mode=split.name)
        batch = next(ds.as_batches(items, range(len(items)), len(items)))
        sdf, th = batch["sdf"], batch["th_opt"]
    else:
        worlds = yaml.safe_load((split / "meta.yaml").read_text())["num_envs"]
        rows = list(load_split3d(str(split)))
        sdf = np.stack([r[1] for r in rows]).astype(np.float32)
        th = np.stack([r[4] for r in rows])
    n = len(th)
    if not files == n == worlds * probs:
        raise AssertionError(f"{name}: {files} files, {n} read back, "
                             f"{worlds} x {probs} written")
    lims = (LIMS,) * ndim
    dist, _ = sdf_ops.lookup_nd(torch.tensor(sdf),
                                torch.tensor(th[..., :ndim]),
                                10.0 / sdf.shape[-1], *lims)
    clear = float(dist.min())
    print(f"{name}: {n} labels read back from disk, smallest clearance "
          f"{clear:.4f} m (plain lookup on the CPU; robot radius 0.4)")
    if not clear > PointRobot2D().sphere_radii[0]:
        raise AssertionError(f"{name}: a label collides ({clear})")
    return clear


def profile_expert(name, smi, plan, iters):
    """One plan under the profiler: its device-busy share of the wall and
    device launches per iteration."""
    _, rec = profile_run(plan)
    print(f"[{smi}] {name}, one plan profiled: wall {rec['wall_ms']:.3f} "
          f"ms, device busy {rec['busy_ms']:.3f} ms "
          f"({rec['busy_ms'] / rec['wall_ms']:.4f} of the wall), "
          f"{rec['ops'] / iters:.2f} device launches per iteration")


def data_golden_errors(dev, root=None):
    """The port's ``generate_split`` at the data golden's configuration on
    ``dev`` (float32, the kernels on the card) against the JAX package's
    output: errors of the maps (cells that differ), starts, goals, SDFs,
    ``th_init`` and ``th_opt`` (largest absolute), ``rng`` (the generator's
    state after equals JAX's), and the run's counts."""
    import shutil

    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.data import dataset as ds
    from dgpmp2_tpu_torch.data import generate
    from dgpmp2_tpu_torch.robots import PointRobot2D

    g = np.load(GOLDEN_DATA)
    c = json.loads(str(g["config"]))
    root = Path(root or ROOT / "build" / "data_golden")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(c["seed"])
    n, probs = c["num_envs"], c["probs_per_env"]
    cov = dict(qc_inv=np.eye(2), cost_sigma=c["cost_sigma"],
               epsilon_dist=c["epsilon_dist"], k_s=c["k_s"], k_g=c["k_g"])
    stats = generate.generate_split(
        str(root / "train"), n, probs, c["family"], c["im_size"], rng,
        graph.GraphSpec(total_time_step=c["T"]), PointRobot2D(),
        gn.OptimConfig(reg=c["reg"], max_iters=c["max_iters"],
                       method=c["method"]), cov, device=dev)
    data = ds.PlanningDataset(str(root), mode="train")
    envs = [data._load_env(e) for e in range(n)]
    labels = [np.load(root / "train" / "opt_trajs_gpmp2"
                      / f"env_{e}_prob_{j}.npz")
              for e in range(n) for j in range(probs)]
    got = {k: np.stack([z[k] for z in labels])
           for k in ("start", "goal", "th_init", "th_opt")}
    got["sdf"] = np.stack([s for _, s in envs])
    errs = {k: float(np.abs(got[k] - g[k]).max()) for k in got}
    errs["maps"] = int((np.stack([m for m, _ in envs]).astype(np.uint8)
                        != g["maps"]).sum())
    errs["rng"] = rng.bit_generator.state == json.loads(str(g["rng_state"]))
    shutil.rmtree(root, ignore_errors=True)
    return errs, stats


def data_golden_ok(errs) -> bool:
    return errs["rng"] and all(errs[k] <= tol
                               for k, tol in DATA_GOLDEN_TOL.items())


def check_data_golden(dev, smi):
    """The JAX golden of a small forest split, remade on the card."""
    with counting_plans() as rec:
        (errs, stats), _ = drive(
            "data golden (generate_split 64^2, T=20, 2 x 2, LM 5 iterations)",
            lambda: data_golden_errors(dev),
            lambda _: plan_counts(rec))
    print(f"data golden on the card against the JAX package: {errs} "
          f"(tolerances {DATA_GOLDEN_TOL}, the generator's state equal); "
          f"{stats['plans']} plans for 2 worlds")
    if not data_golden_ok(errs):
        raise AssertionError(f"data golden: {errs}")


def first_world(split, probs, dev):
    """(start, goal, sdf batch on ``dev``) of a split's first world, read
    from its files."""
    sdf = np.load(split / "im_sdf" / "0_sdf.npy").astype(np.float32)
    rows = [np.load(split / "opt_trajs_gpmp2" / f"env_0_prob_{j}.npz")
            for j in range(probs)]
    start = np.stack([r["start"] for r in rows])
    goal = np.stack([r["goal"] for r in rows])
    sdfb = torch.tensor(sdf, device=dev).expand(probs, *sdf.shape)
    return start, goal, sdfb.contiguous()


def datagen(dev, smi):
    """Phase 12: the port's data generators on the card at the campaigns'
    widths; returns the dataset root phase 13 trains on."""
    phase(f"12 data generation ({IMSIZE}^2 forest, T={T}, LM "
          f"{DATA_ITERS} iterations, float32)")
    import shutil

    from dgpmp2_tpu_torch import native
    from dgpmp2_tpu_torch.core import gn, graph, multistart
    from dgpmp2_tpu_torch.core.seeds import rrt_seed_batch
    from dgpmp2_tpu_torch.data import dataset as ds
    from dgpmp2_tpu_torch.data import (generate, generate3d, generate_im,
                                       generate_paths, sensitivity)
    from dgpmp2_tpu_torch.robots import PointRobot2D, PointRobot3D

    root = ROOT / "build" / "datagen"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    check_data_golden(dev, smi)
    spec, robot = graph.GraphSpec(total_time_step=T), PointRobot2D()
    lm = gn.OptimConfig(reg=0.1, max_iters=DATA_ITERS, method="lm")

    # (a) The 2-D expert datasets.
    rng = np.random.default_rng(0)
    for mode, n in (("train", TRAIN_ENVS), ("test", DATA_TEST_ENVS)):
        name = f"(a) generate_split forest {mode}, {n} worlds x {DATA_PROBS}"
        stats, rec = generation(name, smi, lambda: generate.generate_split(
            str(data / mode), n, DATA_PROBS, "forest", IMSIZE, rng, spec,
            robot, lm, DATA_COV, device=dev), n)
        acceptance(name, stats, n, DATA_PROBS, rec)
        revalidate(name, data / mode, DATA_PROBS)
    start, goal, sdfb = first_world(data / "test", DATA_PROBS, dev)
    params, th0 = generate.expert_problem(spec, robot, DATA_COV, start, goal,
                                          dev)
    with torch.no_grad():
        profile_expert(f"(a) expert (LM, track_best, B={DATA_PROBS})", smi,
                       lambda: gn.plan(spec, robot, params, th0, sdfb, lm,
                                       track_best=True), DATA_ITERS)

    # (b) RRT* seeds for the expert.
    name = f"(b) generate_split --rrtstar_init, {RRT_ENVS} worlds"
    stats, rec = generation(name, smi, lambda: generate.generate_split(
        str(root / "rrt" / "train"), RRT_ENVS, DATA_PROBS, "forest", IMSIZE,
        np.random.default_rng(1), spec, robot, lm, DATA_COV,
        max_env_retries=RRT_RETRIES, rrtstar_init=True, device=dev),
        RRT_ENVS)
    acceptance(name, stats, RRT_ENVS, DATA_PROBS, rec)
    lib = native.library_path()
    if (native._lib is None or not lib.is_file()
            or lib.parent != ROOT / "dgpmp2_tpu_torch" / "build"):
        raise AssertionError(f"RRT* library {lib}")
    print(f"{name}: RRT* found {stats['rrt_found']} paths in "
          f"{stats['rrt_searches']} searches (2 s budget each); library "
          f"{lib.relative_to(ROOT)}")
    revalidate(name, root / "rrt" / "train", DATA_PROBS)

    # (c) 3-D.
    c3 = DATA3D
    name = (f"(c) generate_split3d boxes3d {c3['size']}^3, T={c3['t']}, "
            f"{c3['envs']} worlds x {c3['probs']}")
    stats, rec = generation(name, smi, lambda: generate3d.generate_split3d(
        str(root / "d3"), c3["envs"], c3["probs"], "boxes3d", c3["size"],
        np.random.default_rng(2), t=c3["t"], max_iters=c3["max_iters"],
        device=dev), c3["envs"], lookup="sdf_lookup3d")
    print(f"{name}: {stats['attempts']} world draws for {c3['envs']} worlds "
          f"({c3['envs'] / stats['attempts']:.4f} accepted per draw; a "
          f"colliding world is redrawn whole)")
    revalidate(name, root / "d3", c3["probs"], ndim=3)
    spec3 = graph.GraphSpec(dof=3, state_dim=6, total_time_step=c3["t"],
                            x_lims=LIMS, y_lims=LIMS, z_lims=LIMS)
    lm3 = gn.OptimConfig(reg=0.1, max_iters=c3["max_iters"], method="lm")
    start, goal, sdfb = first_world(root / "d3", c3["probs"], dev)
    params, th0 = generate.expert_problem(spec3, PointRobot3D(),
                                          generate3d.DEFAULT_COV, start, goal,
                                          dev)
    with torch.no_grad():
        profile_expert(f"(c) expert (LM, track_best, B={c3['probs']})", smi,
                       lambda: gn.plan(spec3, PointRobot3D(), params, th0,
                                       sdfb, lm3, track_best=True),
                       c3["max_iters"])

    # (d) An image dataset, then expert paths on its test split, both at
    # their CLIs' defaults (seed 0).  A world whose random pairs GN cannot
    # label in max_retries draws ends the run with the generator's loud
    # RuntimeError, by design (the JAX package stops at the same world);
    # the labels written before it are checked.
    t0 = time.perf_counter()
    generate_im.generate(str(root / "im"), "multi_obstacle", IMSIZE,
                         IM_TRAIN, IM_TEST, seed=0)
    wall = time.perf_counter() - t0
    print(f"(d) generate_im multi_obstacle {IMSIZE}^2: {IM_TRAIN} + "
          f"{IM_TEST} worlds in {wall:.3f} s ({wall / (IM_TRAIN + IM_TEST):.5f}"
          f" s per world; host EDT of the port's native library)")
    gn_cfg = gn.OptimConfig(reg=0.1, max_iters=DATA_ITERS)

    def expert_paths():
        try:
            return generate_paths.add_expert_paths(
                str(root / "im" / "test"), PATH_PROBS, "random", spec, robot,
                gn_cfg, DATA_COV, np.random.default_rng(0), device=dev), None
        except RuntimeError as err:
            stop = re.match(r"env (\d+): no collision-free expert path",
                            str(err))
            if stop is None:
                raise
            return int(stop.group(1)), str(err)

    name = (f"(d) add_expert_paths random, {IM_TEST} worlds x {PATH_PROBS},"
            f" GN")
    (labelled, stop), rec = generation(name, smi, expert_paths)
    print(f"{name}: {labelled} worlds labelled in {rec['plans']} plans "
          f"({labelled / rec['plans']:.4f} accepted per attempt)"
          + (f"; stopped: {stop}" if stop else ""))
    revalidate(name, root / "im" / "test", PATH_PROBS,
               worlds=labelled if stop else None)
    start, goal, sdfb = first_world(root / "im" / "test", PATH_PROBS, dev)
    params, th0 = generate.expert_problem(spec, robot, DATA_COV, start, goal,
                                          dev)
    with torch.no_grad():
        profile_expert(f"(d) expert (GN, B={PATH_PROBS})", smi,
                       lambda: gn.plan(spec, robot, params, th0, sdfb,
                                       gn_cfg), DATA_ITERS)

    # (e) The sensitivity sweep over (a)'s test split.
    test = ds.PlanningDatasetMulti([str(data)], mode="test")
    name = (f"(e) run_sweep over {len(test)} test problems, "
            f"{len(sensitivity.DEFAULT_SIGMAS)} sigmas, batch {SWEEP_B}")
    sweep, rec = generation(name, smi, lambda: sensitivity.run_sweep(
        test, np.arange(len(test)), spec, robot, gn_cfg, batch_size=SWEEP_B,
        device=dev), after=2)
    rates = {s: (r["solve_rate"], r["contact_free_rate"])
             for s, r in sweep["per_sigma"].items()}
    print(f"{name}: (solve rate, contact-free rate) by sigma "
          f"{json.dumps(rates)}; best sigma {sweep['best_sigma']}")
    if not all(0.0 <= a <= 1.0 and 0.0 <= b <= 1.0
               for a, b in rates.values()):
        raise AssertionError(f"{name}: {sweep}")

    # (f) RRT* seeds into multistart.
    rows = [test[i] for i in range(SEEDS_B)]
    sdf_np = np.stack([r["sdf"] for r in rows])
    start = np.stack([r["start"] for r in rows])
    goal = np.stack([r["goal"] for r in rows])
    t0 = time.perf_counter()
    extra, found = rrt_seed_batch(sdf_np, start, goal, LIMS, LIMS,
                                  spec.total_time_sec, spec.num_traj_states,
                                  clearance=robot.sphere_radii[0],
                                  plan_time=1.0)
    print(f"(f) rrt_seed_batch: {int(found.sum())} of {SEEDS_B} paths found "
          f"in {time.perf_counter() - t0:.3f} s (1 s budget each)")
    params, th0 = generate.expert_problem(spec, robot, DATA_COV, start, goal,
                                          dev)
    sdfb = torch.tensor(sdf_np, device=dev)
    ms_cfg = gn.OptimConfig(**MS_OPTIM)
    free = {}
    for label, seeds_ in (("without", None), ("with", extra)):
        name = (f"(f) plan_multistart B={SEEDS_B} K={SEEDS_K} {label} "
                f"RRT* seeds")
        out, _ = generation(name, smi, lambda: multistart.plan_multistart(
            spec, robot, params, th0, sdfb, ms_cfg,
            torch.Generator(device=dev).manual_seed(0), restarts=SEEDS_K,
            amp=2.0, extra_seeds=None if seeds_ is None
            else torch.tensor(seeds_, device=dev)[None]))
        if not (bool(torch.isfinite(out.th).all())
                and tuple(out.th.shape) == (SEEDS_B, T + 1, 4)):
            raise AssertionError(f"{name}: {out.th.shape}")
        free[label] = int(out.contact_free.sum())
    print(f"(f) contact-free of {SEEDS_B}: without RRT* seeds "
          f"{free['without']}, with them {free['with']} (the same draws)")
    shutil.rmtree(root / "im", ignore_errors=True)
    shutil.rmtree(root / "rrt", ignore_errors=True)
    return data


# -- phase 13: learned-planner training --------------------------------------

# K-LOOKUP-BWD against its replay: relative to the largest cotangent of the
# call.  The kernel sums in autograd's order but not bit for bit (1e-16
# float64 and 1e-7 float32 seen in a Python mirror of its arithmetic); the
# SDF cotangent's atomics add in no fixed order.
LOOKUP_BWD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The training run: tools/learned_campaign.py's eps_bounded (:111-114) with
# its CLI defaults (:438-443) at full width: 128^2, T=100, feed-forward head
# 1000/640 with dropout 0.1, Adam 3e-4, batch 128, unroll 10 in windows of
# 5, ext loss 1 with obstacle weight 5 and no imitation term.  96 forest
# worlds x 4 problems: two batches of 128 to train on per epoch and one to
# validate (valid_size 0.334).
TRAIN_ENVS, TRAIN_PROBS, TRAIN_B, TRAIN_UNROLL, TRAIN_TK = 96, 4, 128, 10, 5


def eps_bounded_learn(epochs, batch=TRAIN_B, unroll=TRAIN_UNROLL,
                      tk=TRAIN_TK, valid_size=0.334, every=3):
    """The learn YAML of the campaign's eps_bounded configuration;
    validation and checkpoint every ``every`` epochs."""
    return {
        "model": {"type": "feed_forward", "dropout_prob": 0.1,
                  "hidden_dim": 64, "num_hidden": 1},
        "data": {"valid_size": valid_size, "expert": "gpmp2",
                 "shuffle": True, "num_train_envs": -1,
                 "num_train_env_probs": -1},
        "optim": {"optimizer": "adam", "alpha": 3e-4, "reg_strength": 0.0,
                  "batch_size": batch, "epochs": epochs, "save_epoch": every,
                  "eval_epoch": every, "do_validation": True,
                  "clip_grad": True, "clip_val": 2.0,
                  "vel_loss_lambda": 0.1, "ext_obs_lambda": 5.0,
                  "ext_loss_weight": 1.0, "pos_loss_weight": 0.0,
                  "max_pen_weight": 0.0, "max_pen_beta": 30.0},
        "dgpmp2": {"dynamics_mode": "diag_identity", "learn_eps": True,
                   "eps_max": 0.8, "static_init": True, "sdf_predict": True,
                   "dtheta_predict": False, "fixed_conv": False,
                   "T": unroll, "tk": tk, "use_inter_loss": True,
                   "optimize_tk": False},
    }


def training_argv(root, data, out, learn, t=T, iters=50, device="cuda",
                  tag="learn"):
    """train_planner/test_planner arguments of a run under ``root``: the
    repo's 2-D YAMLs with T=t, ``iters`` GN iterations and cost_sigma 0.01
    (eps_bounded's static init (1.0, 0.01, 0.4), which build_planner reads
    from the same YAML), and ``learn`` as the learn YAML."""
    import yaml

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    plan = yaml.safe_load((CONFIGS / "gpmp2_2d_params.yaml").read_text())
    g = plan["gpmp2"]
    g["planner_params"]["total_time_step"] = t
    g["optim_params"]["max_iters"] = iters
    g["obs_params"]["cost_sigma"] = 0.01
    (root / "plan.yaml").write_text(yaml.safe_dump(plan))
    (root / f"{tag}.yaml").write_text(yaml.safe_dump(learn))
    return ["--dataset_folders", str(data), "--device", str(device),
            "--plan_param_file", str(root / "plan.yaml"),
            "--robot_param_file", str(CONFIGS / "robot_2d.yaml"),
            "--env_param_file", str(CONFIGS / "env_2d_params.yaml"),
            "--learn_param_file", str(root / f"{tag}.yaml"),
            *(["--out_folder", str(out)] if out is not None else [])]


def train_step_counts(steps, unroll=TRAIN_UNROLL, remat=True, plan_iters=0,
                      seed_lookup=False):
    """Launches of ``steps`` chunked training steps and, with
    ``plan_iters``, a learned plan of that many iterations (one more lookup
    at its seed with ``seed_lookup``: track_best) and its evaluation
    (``learn.eval.evaluate_batch``: two lookups).  A training step makes a
    K-BTD solve per GN step, again in each window's recompute under
    ``remat``, and its adjoint; a lookup at the seed and at each new
    iterate, again in the recompute; a K-LOOKUP-BWD launch per GN step (the
    new iterate's lookup, whose geometry the loss and the next step
    share)."""
    again = unroll if remat else 0
    plan_lookups = plan_iters + (seed_lookup + 2 if plan_iters else 0)
    return {"btd_solve": steps * (2 * unroll + again) + plan_iters,
            "sdf_lookup": steps * (1 + unroll + again) + plan_lookups,
            "sdf_lookup_bwd": steps * unroll}


def lookup_bwd_bound(points, ndim, taps, dtype, sdf_grad):
    """bound_ms, bound_by, library_ms of K-LOOKUP-BWD over ``points``
    points: each reads its coordinates, its cotangents (1 + ndim) and its
    ``taps`` taps and writes its cotangent (ndim), with ``sdf_grad`` also
    adding into its taps' cotangents; a few tens of flops a point.  No single
    PyTorch call returns the point cotangent through both outputs."""
    sz = torch.finfo(dtype).bits // 8
    per = (ndim + 1 + ndim + ndim) * sz + taps * sz * (2 if sdf_grad else 1)
    ms, by = bound(points * per, points * 12 * taps, dtype)
    return {"bound_ms": ms, "bound_by": by, "library_ms": None}


def compare_bwd(name, got, want, tol, quiet=True):
    """Largest error of (p_bar, s_bar) relative to the replay's largest
    entry (0 where both are 0: a point outside the world in the intended
    mode); raises past ``tol``."""
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
            for a, b in zip(got, want) if b is not None and b.numel()]
    err = max(errs, default=0.0)
    if not quiet:
        print(f"{name}: max rel err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err}")
    return err


def bwd_cases(dev, rng, dtype, b, p, ndim, grid, res, lims, far=True):
    """(sdf, points, d_bar, g_bar) with random SDF and cotangents, points
    as lookup_points (one in ten outside, the border) and, with ``far``,
    one far outside the grid."""
    sdf = torch.tensor(rng.standard_normal((b, *grid)), dtype=dtype,
                       device=dev)
    pts = lookup_points(rng, p, ndim, b)
    if ndim == 3:
        pts *= np.array([1.0, 0.6, 0.8])  # the 16 x 12 x 20 grid's world
    if far:
        pts[0, 0] = 1e10
    pts_t = torch.tensor(pts, dtype=dtype, device=dev)
    d_bar = torch.tensor(rng.standard_normal((b, p)), dtype=dtype, device=dev)
    g_bar = torch.tensor(rng.standard_normal((b, p, ndim)), dtype=dtype,
                         device=dev)
    return sdf, pts_t, d_bar, g_bar


def check_bwd_call(name, sdf, pts, d_bar, g_bar, res, lims, mode):
    """K-LOOKUP-BWD against the replay on one input: the point cotangent
    alone, then with the SDF's; in the reference mode the points beyond
    1e3 m (weights of ~1e10, whose contributions to one cell cancel to the
    rounding of that size in the replay's scatter) carry no cotangent in
    the second call.  Returns the largest relative error."""
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_bwd as k

    tol = LOOKUP_BWD_TOL[sdf.dtype]
    args = (res, lims, mode)
    worst = compare_bwd(f"{name} p_bar",
                        k.launch(sdf, pts, d_bar, g_bar, *args, False),
                        k.replay(sdf, pts, d_bar, g_bar, *args, False), tol)
    if mode == "reference":
        keep = (pts.abs() < 1e3).all(-1)
        d_bar, g_bar = d_bar * keep, g_bar * keep[..., None]
    return max(worst, compare_bwd(
        f"{name} p_bar, s_bar", k.launch(sdf, pts, d_bar, g_bar, *args),
        k.replay(sdf, pts, d_bar, g_bar, *args), tol))


def check_lookup_bwd(dev, record, smi, captured):
    """K-LOOKUP-BWD against the replay in both dtypes and OOB modes: at the
    lookup tiles' edge shapes (far points too), on the training path's own
    lookups (``captured``: one step's kernel inputs), at B=128, P=101 on
    128^2 grids, and at the learned 3-D shape (B=128, 32^3, T=20); timed
    on the training path's points (device-only, L2 flushed) beside its
    bound and the replay."""
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_bwd as k
    from dgpmp2_tpu_torch.ops.sdf import OOB_MODES

    rng = np.random.default_rng(12)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    grids = {2: ((32, 32), 10.0 / 32, (LIMS, LIMS)),
             3: ((16, 12, 20), 0.5, (LIMS, (-3.0, 3.0), (-4.0, 4.0)))}
    for dtype in LOOKUP_DTYPES:
        for ndim, (grid, res, lims) in grids.items():
            for b, p in LOOKUP_EDGES:
                case = bwd_cases(dev, rng, dtype, b, p, ndim, grid, res,
                                 lims)
                for mode in OOB_MODES:
                    worst[dtype] = max(worst[dtype], check_bwd_call(
                        f"K-LOOKUP-BWD {ndim}-D B={b} P={p}", *case, res,
                        lims, mode))
        shapes = (("2-D B=128 P=101 128^2", 2, (IMSIZE, IMSIZE),
                   10.0 / IMSIZE, (LIMS, LIMS)),
                  ("3-D B=128 P=21 32^3", 3, (32, 32, 32), 10.0 / 32,
                   (LIMS, LIMS, LIMS)))
        for name, ndim, grid, res, lims in shapes:
            case = bwd_cases(dev, rng, dtype, TRAIN_B,
                             (T if ndim == 2 else LEARN3D_T) + 1, ndim, grid,
                             res, lims)
            for mode in OOB_MODES:
                worst[dtype] = max(worst[dtype], check_bwd_call(
                    f"K-LOOKUP-BWD {name} {dtype} {mode}", *case, res, lims,
                    mode))
        for i, (sdf, pts, d_bar, g_bar, res, lims, mode) in enumerate(
                captured):
            args = [x.to(dtype) for x in (sdf, pts, d_bar, g_bar)]
            worst[dtype] = max(worst[dtype], check_bwd_call(
                f"K-LOOKUP-BWD training lookup {i} {dtype}", *args, res,
                lims, mode))
    print(f"K-LOOKUP-BWD against the autograd replay at (B, P) in "
          f"{LOOKUP_EDGES} (2-D 32^2, 3-D 16x12x20), B=128 P=101 128^2, "
          f"B=128 P=21 32^3 and on {len(captured)} lookups of a training "
          f"step, both OOB modes: max rel err float32 "
          f"{worst[torch.float32]:.3e} (tol {LOOKUP_BWD_TOL[torch.float32]:g})"
          f", float64 {worst[torch.float64]:.3e} (tol "
          f"{LOOKUP_BWD_TOL[torch.float64]:g})")
    sdf, pts, d_bar, g_bar, res, lims, mode = captured[-1]
    n = pts.shape[0] * pts.shape[1]
    for sdf_grad in (True, False):
        rec = {}
        run = (sdf, pts, d_bar, g_bar, res, lims, mode, sdf_grad)
        got, want = k.launch(*run), k.replay(*run)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                  if b is not None)
        kernel_ms(rec, lambda: k.launch(*run), lambda: k.replay(*run),
                  "sdf_lookup_bwd_kernel")
        rec.update(lookup_bwd_bound(n, 2, 4, pts.dtype, sdf_grad))
        what = "point and SDF cotangents" if sdf_grad else (
            "point cotangent (the training path)")
        print(f"[{smi}] K-LOOKUP-BWD B={pts.shape[0]} P={pts.shape[1]} "
              f"{IMSIZE}^2 float32, {what}, on a training step's lookup: "
              f"{times_line(rec)}")
    record.update(rec, max_abs_err=err)


def train_batch(planner, dataset_root, cov_scalars, b):
    """The first ``b`` problems of a dataset as a training batch on the
    planner's device."""
    from dgpmp2_tpu_torch.data import dataset as ds
    from dgpmp2_tpu_torch.learn.train_planner import _to_batch

    d = ds.PlanningDatasetMulti([str(dataset_root)])
    return _to_batch(next(ds.as_batches(d, range(len(d)), b)), cov_scalars,
                     planner.device)


def check_training_run(name, history, epochs, want_validation):
    """Finite per-epoch losses for ``epochs`` epochs, and the validation
    suite where asked."""
    losses = [h["loss"] for h in history]
    finite = len(losses) == epochs and all(np.isfinite(losses))
    val = [h["validation"] for h in history if "validation" in h]
    print(f"{name}: epochs {[h['epoch'] for h in history]}, loss "
          f"{', '.join(f'{v:.5g}' for v in losses)}"
          + (f"; validation solve_rate {val[0]['solve_rate']:.4f}, "
             f"contact_free_rate {val[0]['contact_free_rate']:.4f}"
             if val else ""))
    if not finite or (len(val) == 1) != want_validation:
        raise AssertionError(f"{name}: {history}")


def training(dev, smi, record, data):
    """Phase 13: run train_planner.main on phase 12's dataset ``data`` at
    the campaign's full width for 3 epochs (a validation pass and a
    checkpoint), resume it for a fourth, evaluate it with test_planner.main,
    time a training step, check K-LOOKUP-BWD against the replay, time the
    launch floor of K-LOOKUP and K-LOOKUP-BWD, and check a float64 training
    step on the card against the CPU."""
    phase(f"13 learned-planner training (B={TRAIN_B}, {IMSIZE}x{IMSIZE}, "
          f"T={T}, float32)")
    import shutil

    from dgpmp2_tpu_torch.learn import checkpoints, test_planner
    from dgpmp2_tpu_torch.learn import train_planner as tp
    from dgpmp2_tpu_torch.learn.train import make_train_step
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_bwd

    root = ROOT / "build" / "train_run"
    shutil.rmtree(root, ignore_errors=True)
    out = root / "run"
    argv = training_argv(root, data, out, eps_bounded_learn(3))
    (state, history), _ = drive(
        "train_planner.main, 3 epochs of 2 steps, a validation pass",
        lambda: tp.main(argv), train_step_counts(6, plan_iters=50))
    check_training_run("train_planner.main", history, 3, True)
    ckpt = out / "checkpoints"
    if (checkpoints.latest_step(ckpt) != 3 or state.step != 6
            or not (out / "train_losses.yaml").is_file()
            or not (out / "train_val_split.yaml").is_file()):
        raise AssertionError("train_planner.main: checkpoint or outputs")
    argv4 = training_argv(root, data, out, eps_bounded_learn(4), tag="learn4")
    (state, history), _ = drive(
        "train_planner.main --resume, a fourth epoch",
        lambda: tp.main(argv4 + ["--resume"]), train_step_counts(2))
    check_training_run("train_planner.main --resume", history, 1, False)
    if checkpoints.latest_step(ckpt) != 4 or state.step != 8:
        raise AssertionError(f"resume: step {state.step}")
    results = root / "results.yaml"
    summary, _ = drive("test_planner.main (track_best, 50 iterations)",
                       lambda: test_planner.main(
                           training_argv(root, data, None,
                                         eps_bounded_learn(4), tag="learn4")
                           + ["--model_folder", str(out), "--out_file",
                              str(results), "--batch_size", str(TRAIN_B)]),
                       train_step_counts(0, plan_iters=50,
                                         seed_lookup=True))
    print(f"test_planner.main on the validation split: solve_rate "
          f"{summary['solve_rate']:.4f}, contact_free_rate "
          f"{summary['contact_free_rate']:.4f}, avg_gp_error "
          f"{summary['avg_gp_error']:.5g}")
    if not (results.is_file() and 0.0 <= summary["solve_rate"] <= 1.0
            and np.isfinite(summary["avg_gp_error"])):
        raise AssertionError(f"test_planner.main: {summary}")

    # One training step of the resumed run, timed and profiled.
    args, _ = tp._parser("").parse_known_args(argv4)
    planner, learn, gp, obs, _ = tp.load_run(args)
    tcfg, weights = tp.train_config_of(learn)
    train_step = make_train_step(planner, weights, tcfg)
    batch = train_batch(planner, data, tp.cov_scalars_of(gp, obs), TRAIN_B)
    captured, launch = [], sdf_lookup_bwd.launch

    def capture(sdf, pts, d_bar, g_bar, res, lims, mode, sdf_grad=True):
        captured.append((sdf.clone(), pts.clone(), d_bar.clone(),
                         g_bar.clone(), res, lims, mode))
        return launch(sdf, pts, d_bar, g_bar, res, lims, mode, sdf_grad)

    sdf_lookup_bwd.launch = capture
    try:
        (state, metrics), _ = drive("one training step", lambda: train_step(
            state, batch, 0), train_step_counts(1))
    finally:
        sdf_lookup_bwd.launch = launch
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise AssertionError(f"training step: {metrics}")
    step_ms = cuda_ms(lambda: train_step(state, batch, 0), reps=5, warmup=1)
    _, prof = profile_run(lambda: train_step(state, batch, 0))
    stack = planner.stack_inputs(batch["im"], batch["sdf"])

    def encoder():
        planner.conv_features(state.variables, stack).sum().backward()

    _, enc = profile_run(encoder)
    bwd = prof.get("sdf_lookup_bwd", {})
    print(f"[{smi}] training step (eps_bounded, B={TRAIN_B}, {IMSIZE}^2, "
          f"T={T}, unroll {TRAIN_UNROLL} in windows of {TRAIN_TK}, remat, "
          f"Adam) float32: {step_ms:.3f} ms per step (CUDA events, median of "
          f"5); one profiled step: wall {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['busy_ms']:.3f} ms ({prof['busy_ms'] / prof['wall_ms']:.4f}"
          f" of the wall), {prof['ops']} device launches; the encoder's "
          f"forward and backward {enc['busy_ms']:.3f} ms device "
          f"({enc['busy_ms'] / prof['busy_ms']:.4f} of the step's); "
          f"K-LOOKUP-BWD {bwd.get('launches', 0)} launches, "
          f"{bwd.get('us', float('nan')):.2f} us each")
    check_lookup_bwd(dev, record, smi, captured)
    launch_floor(dev, smi)
    train_step_card_vs_cpu(dev)
    shutil.rmtree(root, ignore_errors=True)


def launch_floor(dev, smi, rounds=2):
    """K-LOOKUP and K-LOOKUP-BWD (point cotangent) at B=1, P=1 on a 128^2
    float32 SDF, beside a one-element ``sqrt_`` (no kernel does less):
    device-only (profiler, L2 flushed) and CUDA-graph times, the floor of
    one launch of each, in ``rounds`` rounds, the order turned each
    round."""
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup, sdf_lookup_bwd

    rng = np.random.default_rng(13)
    f32 = dict(dtype=torch.float32, device=dev)
    sdf = torch.tensor(rng.standard_normal((1, IMSIZE, IMSIZE)), **f32)
    pts = torch.tensor([[[0.3, -1.2]]], **f32)
    d_bar, g_bar = torch.ones((1, 1), **f32), torch.ones((1, 1, 2), **f32)
    one = torch.ones(1, **f32)
    res = 10.0 / IMSIZE
    at = f"at B=1 P=1 ({IMSIZE}^2 float32)"
    runs = [(f"K-LOOKUP {at}", "sdf_lookup_kernel",
             lambda: sdf_lookup.launch(sdf, pts, res, LIMS, LIMS)),
            (f"K-LOOKUP-BWD {at}", "sdf_lookup_bwd_kernel",
             lambda: sdf_lookup_bwd.launch(sdf, pts, d_bar, g_bar, res,
                                           (LIMS, LIMS), "intended", False)),
            ("sqrt_ of one element", "sqrt", lambda: one.sqrt_())]
    for r in range(rounds):
        for name, kernel, fn in runs[r:] + runs[:r]:
            print(f"[{smi}] launch floor, round {r}, {name}: device-only "
                  f"{device_ms(fn, kernel):.5f} ms (profiler, L2 flushed), "
                  f"CUDA graph {graph_ms(fn):.5f} ms")


def train_step_card_vs_cpu(dev, b=16, unroll=4, tk=2):
    """One float64 training step (B=16, 128^2, T=100, unroll 4 in windows
    of 2, SGD at 0.01, so that each update is the clipped gradient) of the
    eps_bounded planner with random weights on the card against the CPU, on
    the chunked and the LM path, leaf by leaf relative to the leaf's largest
    entry.  With the head decoded in float64 (:func:`decode_in_float64`):
    every updated weight within 1e-10, and every update, the gradient
    itself, within 1e-9 (1.6e-10 seen: cuDNN's and the CPU's convolution
    backward sum in other orders, and a LayerNorm scale's gradient cancels
    over B·H·W terms).  Through the shipped float32 decode both are
    reported.  Dropout 0 (each device draws its own masks)."""
    from dgpmp2_tpu_torch import convert
    from dgpmp2_tpu_torch.learn.losses import LossWeights
    from dgpmp2_tpu_torch.learn.train import (TrainConfig, TrainState,
                                              make_optimizer,
                                              make_train_step)

    imgs, start, goal = bench_inputs(b, seed=3)
    th_opt = np.random.default_rng(3).standard_normal((b, T + 1, 4)) * 0.1
    cov = dict(qc_inv=np.eye(2), cost_sigma=0.01, epsilon_dist=0.4,
               k_s=0.01, k_g=0.01)
    lkw = dict(EPS_BOUNDED, dropout_prob=0.0)
    weights = LossWeights(ext_loss_weight=1.0, ext_obs_lambda=5.0,
                          pos_loss_weight=0.1)

    def worst(pairs):
        errs = {p: float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-300))
                for (p, a), (_, c) in zip(*pairs)}
        key = max(errs, key=errs.get)
        return errs[key], key

    for method in ("gauss_newton", "lm"):
        for decode, tols in (("float64", (1e-10, 1e-9)),
                             ("float32", (None, None))):
            after, updates = [], []
            for where in (dev, torch.device("cpu")):
                planner, variables, _, th0, sdf, im = learned_setup(
                    where, imgs, start, goal, lkw=lkw, method=method,
                    dtype=torch.float64, weights_seed=3)
                if decode == "float64":
                    decode_in_float64(planner)
                state = TrainState(0, variables, make_optimizer(
                    "sgd", {"alpha": 0.01})(variables.parameters()))
                step = make_train_step(planner, weights, TrainConfig(
                    T=unroll, tk=tk))
                batch = {"im": im, "sdf": sdf,
                         "start": torch.tensor(start, device=where),
                         "goal": torch.tensor(goal, device=where),
                         "th_opt": th0 + torch.tensor(th_opt, device=where),
                         "cov_scalars": cov}
                before = _leaves(convert.learned_state_to_flax(variables))

                def run():
                    return step(state, batch, 0)

                if where.type == "cuda":
                    drive(f"training step ({method}, float64, B={b}, "
                          f"{decode} decode)", run,
                          train_step_counts(1, unroll))
                else:
                    run()
                new = _leaves(convert.learned_state_to_flax(variables))
                after.append(new)
                updates.append([(p, a - o) for (p, a), (_, o) in zip(new,
                                                                    before)])
            (e_w, at_w), (e_u, at_u) = worst(after), worst(updates)
            tol_w, tol_u = tols
            bound = (f" (tol {tol_w:g})", f" (tol {tol_u:g})") if tol_w else (
                " (reported)", " (reported)")
            print(f"training step ({method}, float64, B={b}) on the card "
                  f"against the CPU, {decode} decode, {len(after[0])} weight "
                  f"tensors: max rel err of the updated weights {e_w:.3e} at "
                  f"{at_w}{bound[0]}, of the updates {e_u:.3e} at "
                  f"{at_u}{bound[1]}")
            if tol_w is not None and not (e_w <= tol_w and e_u <= tol_u):
                raise AssertionError(f"training step {method}: {e_w}, {e_u}")

# -- phase 14: serving -------------------------------------------------------

SERVE_B, SERVE_ITERS, SERVE_WINDOW_MS = 256, 50, 5.0
SERVE_LEVELS, SERVE_ROUNDS = (1, 8, 64, 256), 3
# Concurrency 1 runs this many requests one after the other: enough for its
# p99 (serve_p99_ms_c1), ~45 s at ~150 ms a request.
SERVE_C1_ROUNDS = 300
SERVE_WARM_C = 64  # the level replanned from warm starts
# benchmarks/bench_serve.py's multistart cell (:109-129): K=16, LM, amp 2.0
# at batch 64, a 1,024-plan pool; RRT*-seeded at 2 seeds a problem, batch
# 16, the search's iteration cap binding long before its time budget.
SERVE_MS_B, SERVE_MS_K = 64, 16
SERVE_RRT_B, SERVE_RRT_SEEDS, SERVE_RRT_ITERS = 16, 2, 1000
SERVE_WORLDS3D, SERVE_TASK_B = 16, 64
# The serving metrics of PERF.md section 2, filled by serving(): name ->
# (value, the number of requests it was measured on).
SERVE_METRICS = {}


def bench_serve():
    """``tools/bench_serve_torch.py`` as a module (``tools/`` is no
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_serve_torch", ROOT / "tools" / "bench_serve_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_drive(name, svc, run, per_dispatch):
    """:func:`drive` a serving run: the launch counts must be
    ``per_dispatch`` (by kernel) times the dispatches the run made."""
    b0 = svc.stats["batches"]
    out, _ = drive(name, run, lambda _: {
        k: v * (svc.stats["batches"] - b0) for k, v in per_dispatch.items()})
    return out


def asyncio_run(svc, coro_fn):
    """Start ``svc``, await ``coro_fn()``, stop ``svc``: the result."""
    import asyncio

    async def main():
        await svc.start()
        try:
            return await coro_fn()
        finally:
            await svc.stop()

    return asyncio.run(main())


def check_responses(name, responses, fills, max_iters, exact_iters=False):
    """Finite plans and errors, ``err_final < err_init`` on at least 95 %
    of them, each response's ``batch_fill`` as ``fills`` (one per
    response) and its iterations in 1..``max_iters`` (exactly
    ``max_iters`` with ``exact_iters``)."""
    finite = all(np.isfinite(r.th).all() and np.isfinite(r.err_init)
                 and np.isfinite(r.err_final) for r in responses)
    better = float(np.mean([r.err_final < r.err_init for r in responses]))
    iters = [r.iters for r in responses]
    iters_ok = (all(i == max_iters for i in iters) if exact_iters
                else all(1 <= i <= max_iters for i in iters))
    fill_ok = [r.batch_fill for r in responses] == list(fills)
    if not (finite and better >= 0.95 and iters_ok and fill_ok):
        raise AssertionError(
            f"{name}: finite={finite} improved={better} iters "
            f"{min(iters)}..{max(iters)} fills ok={fill_ok}")
    return better


async def serve_levels(bench, smi, label, svc, make, levels, rounds,
                       max_iters, exact_iters=False):
    """Each level's ``rounds`` rounds of concurrent clients (``make(c,
    seed)``'s requests), checked: every response (:func:`check_responses`;
    full batches, then one of ``c % B``) and coalescing
    (``rounds·ceil(c/B)`` dispatches).  Returns {level: (row, responses)}."""
    b = svc.batch_size
    out = {}
    for c in levels:
        b0 = svc.stats["batches"]
        wall, resps = await bench.run_requests(
            svc, [make(c, 42 + r) for r in range(rounds)])
        row = bench.level_row(c, wall, resps)
        n_batches = svc.stats["batches"] - b0
        # Each round: full batches, then one of the remaining c % B.
        fills = ([1.0] * (c - c % b) + [(c % b) / b] * (c % b)) * rounds
        better = check_responses(f"{label} c={c}", resps, fills, max_iters,
                                 exact_iters)
        print(bench.row_line(smi, row) + f"  {label}; {n_batches} "
              f"dispatches, err_final < err_init on {better:.4f}")
        if n_batches != rounds * -(-c // b):
            raise AssertionError(f"{label} c={c}: {n_batches} dispatches "
                                 f"for {rounds} rounds of {c}")
        out[c] = (row, resps)
    return out


def serve_stats(label, smi, svc):
    s = svc.stats
    print(f"[{smi}] {label} stats: {s['requests']} requests in "
          f"{s['batches']} dispatches, padded rows {s['padded_rows']}, "
          f"device_time_s {s['device_time_s']:.4f}, host_seed_time_s "
          f"{s['host_seed_time_s']:.4f}")


def profile_dispatch(label, smi, svc, reqs, iters):
    """One full dispatch under the profiler: its device-busy share and the
    device operations per GN iteration."""
    _, rec = profile_run(lambda: svc.plan_batch_sync(reqs))
    print(f"[{smi}] {label} one dispatch of {len(reqs)}: wall "
          f"{rec['wall_ms']:.2f} ms, device busy {rec['busy_ms']:.3f} ms "
          f"(share {rec['busy_ms'] / rec['wall_ms']:.4f}), "
          f"{rec['ops'] / iters:.1f} device operations per GN iteration "
          f"(profiler)")
    return rec


def same_th(name, a, b):
    """Paired responses with equal plans: raises unless max |a.th - b.th|
    is 0."""
    diff = max(float(np.abs(x.th - y.th).max()) for x, y in zip(a, b))
    print(f"{name}: max |th difference| {diff:.3e}")
    if diff != 0.0:
        raise AssertionError(f"{name}: {diff}")
    return diff


def serving(dev, smi):
    """Phase 14: ``PlanningService`` on the card, float32, at full width:
    (a) the static 2-D planner, (b) 3-D, (c) multistart and RRT*-seeded
    multistart, (d) the learned planner, (e) the task-space arm; each
    registers its worlds, warms up, and is driven by concurrent submit()s
    (``tools/bench_serve_torch.py``'s functions), launch counts held to
    the dispatches' plans."""
    phase(f"14 serving (batch {SERVE_B}, float32)")
    from dgpmp2_tpu_torch import serve
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    bench = bench_serve()
    iters = SERVE_ITERS
    gn_per = {"btd_solve": iters, "sdf_lookup": iters + 1}

    # (a) The static 2-D planner: gpmp2_2d_params.yaml at T=100, 50 GN
    # iterations, the bench world (128^2), batch 256, window 5 ms.
    planner = bench.make_planner(T, iters, dev)
    world = bench.make_world(dev)
    svc = serve.PlanningService(planner, SERVE_B, SERVE_WINDOW_MS)
    svc.register_world("bench", world)
    t0 = time.perf_counter()
    svc.warmup()
    print(f"[{smi}] (a) warm-up {time.perf_counter() - t0:.3f} s")

    def make(inline=False):
        return lambda c, seed: bench.make_requests(world, c, seed, inline)

    async def levels_a():
        bank = {}
        for c in SERVE_LEVELS:
            bank.update(await serve_levels(
                bench, smi, "(a) bank", svc, make(), (c,),
                SERVE_C1_ROUNDS if c == 1 else SERVE_ROUNDS, iters))
        inline = await serve_levels(bench, smi, "(a) inline", svc,
                                    make(True), (SERVE_B,), SERVE_ROUNDS,
                                    iters)
        # Warm starts: one level again, each request seeded with its bank
        # plan.
        cold = bank[SERVE_WARM_C][1]

        def warm(c, seed):
            reqs = bench.make_requests(world, c, seed)
            for q, r in zip(reqs, cold[(seed - 42) * c:(seed - 41) * c]):
                q.th_init = r.th
            return reqs

        wall, resps = await bench.run_requests(
            svc, [warm(SERVE_WARM_C, 42 + r) for r in range(SERVE_ROUNDS)])
        return bank, inline, (bench.level_row(SERVE_WARM_C, wall, resps),
                              resps)

    bank, inline, (wrow, warm) = serve_drive(
        "serving (a) static 2-D", svc, lambda: asyncio_run(svc, levels_a),
        gn_per)
    print(bench.row_line(smi, wrow) + "  (a) warm starts")
    cold = bank[SERVE_WARM_C][1]
    seeded = max(abs(w.err_init - c.err_final) / c.err_final
                 for w, c in zip(warm, cold))
    not_worse = float(np.mean([w.err_final <= w.err_init * (1 + 1e-4)
                               for w in warm]))
    print(f"(a) warm starts: err_init within {seeded:.3e} (relative) of the "
          f"seeding plan's err_final; err_final <= err_init (1 + 1e-4) on "
          f"{not_worse:.4f}")
    if (seeded > 1e-4 or not_worse < 0.95
            or not all(np.isfinite(w.th).all() for w in warm)):
        raise AssertionError(f"(a) warm starts: {seeded} {not_worse}")
    same_th(f"(a) bank against inline at c={SERVE_B}", bank[SERVE_B][1],
            inline[SERVE_B][1])
    row = bank[1][0]
    SERVE_METRICS["serve_p50_ms_c1"] = (row["p50_ms"], row["n"])
    SERVE_METRICS["serve_p99_ms_c1"] = (row["p99_ms"], row["n"])
    row = bank[SERVE_B][0]
    SERVE_METRICS[f"serve_plans_per_s_b{SERVE_B}_c{SERVE_B}"] = (
        row["plans_per_s"], row["n"])

    # A padded partial batch against planner.plan on the same padded batch
    # (exact) and on the 5 rows alone (the padding's effect, measured).
    reqs = bench.make_requests(world, 5, 7)
    served = svc.plan_batch_sync(reqs)
    pad = reqs + [reqs[0]] * (SERVE_B - 5)
    start = np.stack([q.start for q in pad])
    goal = np.stack([q.goal for q in pad])
    sdf = torch.as_tensor(world, device=dev).expand(SERVE_B, *world.shape)
    th0 = seeds(planner.spec, start, goal, dev)
    with torch.no_grad():
        full = planner.plan(th0, start, goal, sdf.contiguous()).th[:5]
        alone = planner.plan(th0[:5], start[:5], goal[:5],
                             sdf[:5].contiguous()).th
    got = torch.as_tensor(np.stack([r.th for r in served]), device=dev)
    d_full = float((got - full).abs().max())
    d_alone = float((got - alone).abs().max())
    print(f"(a) 5 requests padded to {SERVE_B}: max |th - direct plan of "
          f"the padded batch| {d_full:.3e}, of the 5 rows alone (B=5) "
          f"{d_alone:.3e}; batch_fill {served[0].batch_fill}")
    if d_full != 0.0 or d_alone > 1e-3 or served[0].batch_fill != 5 / SERVE_B:
        raise AssertionError(f"(a) padding: {d_full} {d_alone}")
    full_batch = bench.make_requests(world, SERVE_B, 99)
    profile_dispatch("(a) static 2-D", smi, svc, full_batch, iters)

    # The same service under the limb engine: a bank gather is a new
    # tensor, so each dispatch splits its SDFs into limbs once.
    try:
        sdf_ops.set_lookup_method("pallas_v3_1")
        serve_drive("serving (a) under pallas_v3_1", svc,
                    lambda: asyncio_run(svc, lambda: serve_levels(
                        bench, smi, "(a) pallas_v3_1", svc, make(), (8,), 2,
                        iters)),
                    {"btd_solve": iters, "sdf_lookup_limbs": iters + 1,
                     "limb_splits": 1})
    finally:
        sdf_ops.set_lookup_method("auto")
    serve_stats("(a) static 2-D", smi, svc)
    del svc

    # (b) 3-D: the 3-D YAMLs (T=100, 50 iterations), 16 worlds of 64^3
    # voxels built on the card, batch 256, bank and inline.
    planner3 = bench.make_planner(T, iters, dev, yaml="3d")
    occ, start3, goal3 = bench3d_inputs(SERVE_WORLDS3D, dev)
    worlds3 = sdf_ops.sdf_from_occupancy_3d(
        occ, res=10.0 / VOX, dtype=torch.float32).cpu().numpy()
    del occ
    svc = serve.PlanningService(planner3, SERVE_B, SERVE_WINDOW_MS)
    for i, w in enumerate(worlds3):
        svc.register_world(f"vox{i}", w)
    t0 = time.perf_counter()
    svc.warmup()
    print(f"[{smi}] (b) warm-up {time.perf_counter() - t0:.3f} s")

    def make3(inline):
        def make_c(c, seed):
            rng = np.random.default_rng(seed)
            out = []
            for j in range(c):
                i = j % SERVE_WORLDS3D
                s, g = start3[i].astype(np.float32), goal3[i].astype(
                    np.float32)
                s[:3] += rng.uniform(-0.3, 0.3, 3)
                g[:3] += rng.uniform(-0.3, 0.3, 3)
                out.append(serve.PlanRequest(
                    start=s, goal=g, sdf=worlds3[i] if inline else None,
                    world=None if inline else f"vox{i}"))
            return out
        return make_c

    async def levels_b():
        bank = await serve_levels(bench, smi, "(b) 3-D bank", svc,
                                  make3(False), (SERVE_B,), 2, iters)
        inline = await serve_levels(bench, smi, "(b) 3-D inline", svc,
                                    make3(True), (SERVE_B,), 2, iters)
        return bank, inline

    bank, inline = serve_drive(
        "serving (b) 3-D", svc, lambda: asyncio_run(svc, levels_b),
        {"btd_solve": iters, "sdf_lookup3d": iters + 1})
    same_th("(b) 3-D bank against inline", bank[SERVE_B][1],
            inline[SERVE_B][1])
    profile_dispatch("(b) 3-D", smi, svc, make3(False)(SERVE_B, 99), iters)
    serve_stats("(b) 3-D", smi, svc)
    del svc, worlds3

    # (c) Multistart: K=16, LM, amp 2.0, batch 64 (a 1,024-plan pool): the
    # plan, one scoring lookup and the adapter's two errors.
    ms_per = {"btd_solve": iters, "sdf_lookup": iters + 4}
    adapter = bench.make_multistart_adapter(T, iters, SERVE_MS_K, dev)
    svc = serve.PlanningService(adapter, SERVE_MS_B, SERVE_WINDOW_MS)
    svc.register_world("bench", world)
    svc.warmup()
    serve_drive("serving (c) multistart", svc, lambda: asyncio_run(
        svc, lambda: serve_levels(bench, smi, "(c) multistart K=16", svc,
                                  make(), (1, 8, SERVE_MS_B), SERVE_ROUNDS,
                                  iters)), ms_per)
    # The same request at rows 0 and 5 of one dispatch.
    q = bench.make_requests(world, 1, 3)[0]
    rows = svc.plan_batch_sync([q] + bench.make_requests(world, 4, 4) + [q])
    same_th("(c) multistart: one request at rows 0 and 5", rows[:1],
            rows[5:])
    profile_dispatch("(c) multistart K=16", smi, svc,
                     bench.make_requests(world, SERVE_MS_B, 99), iters)
    serve_stats("(c) multistart", smi, svc)
    del svc

    # RRT*-seeded: 2 seeds a problem, batch 16, the iteration cap binding;
    # one round dispatched twice must replay.
    adapter = bench.make_multistart_adapter(
        T, iters, SERVE_MS_K, dev, rrt_seeds=SERVE_RRT_SEEDS,
        rrt_plan_time=60.0, rrt_max_iters=SERVE_RRT_ITERS)
    svc = serve.PlanningService(adapter, SERVE_RRT_B, SERVE_WINDOW_MS)
    svc.register_world("bench", world)
    svc.warmup()
    once = serve_drive("serving (c) RRT*-seeded multistart", svc,
                       lambda: asyncio_run(svc, lambda: serve_levels(
                           bench, smi, "(c) RRT*-seeded", svc,
                           lambda c, seed: bench.make_requests(world, c, 42),
                           (SERVE_RRT_B,), 2, iters)), ms_per)
    resps = once[SERVE_RRT_B][1]
    same_th("(c) RRT*-seeded: one round dispatched twice",
            resps[:SERVE_RRT_B], resps[SERVE_RRT_B:])
    pool = adapter.host_extra_seeds(
        np.stack([r.start for r in bench.make_requests(world, 4, 42)]),
        np.stack([r.goal for r in bench.make_requests(world, 4, 42)]),
        np.stack([world] * 4))
    print(f"(c) RRT*-seeded: pool {pool.shape}; host seconds per dispatch "
          f"{svc.stats['host_seed_time_s'] / svc.stats['batches']:.3f}")
    serve_stats("(c) RRT*-seeded multistart", smi, svc)
    del svc

    # (d) The learned planner: the campaign's eps_bounded configuration
    # (head 1000/640, 128^2, T=100, 50 GN iterations, track_best), random
    # weights about its static init from a numpy seed, batch 256.
    lplanner, variables = learned_setup(dev, *bench_inputs(2), iters=iters,
                                        weights_seed=5)[:2]
    adapter = serve.LearnedPlanningAdapter(lplanner, variables, bench.COV)
    svc = serve.PlanningService(adapter, SERVE_B, SERVE_WINDOW_MS)
    svc.register_world("bench", world)
    svc.warmup()
    serve_drive("serving (d) learned", svc, lambda: asyncio_run(
        svc, lambda: serve_levels(bench, smi, "(d) learned", svc, make(),
                                  (1, SERVE_B), 2, iters, exact_iters=True)),
        gn_per)
    profile_dispatch("(d) learned", smi, svc,
                     bench.make_requests(world, SERVE_B, 99), iters)
    serve_stats("(d) learned", smi, svc)
    del svc, adapter, lplanner, variables

    serve_taskspace(dev, smi, bench)


def serve_taskspace(dev, smi, bench):
    """Phase 14 (e)."""
    from dgpmp2_tpu_torch import serve
    from dgpmp2_tpu_torch.core import gn

    # (e) The task-space 3-link arm of phase 8 (its YAMLs, LM), batch 64, on
    # phase 8's first 2·64 problems; the tip target rides in the goal state.
    # Served with phase 8's seed (the arm at rest at its start), the plans
    # must equal phase 8's computation, gn.plan on make_params, of the same
    # problems.  Served cold (no th_init), a row gets the adapter's
    # cold_seed, the arm at rest: the same plans, bit for bit.
    tplanner = taskspace_planner(dev)
    gp, obs = tplanner.gp_params, tplanner.obs_params
    cov = dict(qc_inv=gp["Q_c_inv"], cost_sigma=obs["cost_sigma"],
               epsilon_dist=obs["epsilon_dist"], k_s=gp["K_s"],
               k_wg=gp["K_wg"], k_self=gp["K_self"],
               eps_self=obs["self_collision_eps"], k_jl=gp["K_jl"],
               q_min=gp["q_min"], q_max=gp["q_max"])
    adapter = serve.TaskSpacePlanningAdapter(
        tplanner.spec, tplanner.robot, cov, optim_cfg=tplanner.cfg,
        k_goal_off=gp["K_g"], device=dev)
    n_arm, nb = tplanner.cfg.max_iters, SERVE_TASK_B
    img96, start_all, target_all = taskspace_inputs(B)
    rest = seeds(tplanner.spec, start_all[:2 * nb], start_all[:2 * nb],
                 dev).cpu().numpy()
    arm_world = occupancy_sdf(img96[:1], dev)[0].cpu().numpy()
    svc = serve.PlanningService(adapter, nb, SERVE_WINDOW_MS)
    svc.register_world("arm", arm_world)
    svc.warmup()

    def make_arm(rested):
        def make_c(c, seed):
            return [serve.PlanRequest(
                start=start_all[i].astype(np.float32),
                goal=np.concatenate([target_all[i], np.zeros(4)]).astype(
                    np.float32),
                world="arm", th_init=rest[i] if rested else None)
                for i in range((seed - 42) * c, (seed - 41) * c)]
        return make_c

    async def levels_e():
        cold = await serve_levels(bench, smi, "(e) task-space arm (LM)",
                                  svc, make_arm(False), (nb,), 2, n_arm)
        rested = await serve_levels(
            bench, smi, "(e) task-space arm (LM), seeded at rest", svc,
            make_arm(True), (nb,), 2, n_arm)
        return cold[nb][1], rested[nb][1]

    cold, rested = serve_drive(
        "serving (e) task-space arm", svc, lambda: asyncio_run(svc, levels_e),
        {"btd_solve": n_arm, "sdf_lookup": n_arm + 1})
    targets = torch.tensor(target_all[:2 * nb], dtype=torch.float32,
                           device=dev)

    def tip_share(th):
        tips = tplanner.robot.fk(th[:, -1])[0][:, -1]
        return float(((tips - targets).norm(dim=-1) < 0.1).double().mean())

    direct = []
    sdf = torch.as_tensor(arm_world, device=dev).expand(nb, *arm_world.shape)
    with torch.no_grad():
        for r in range(2):
            rows = slice(r * nb, (r + 1) * nb)
            st = start_all[rows]
            direct.append(gn.plan(
                tplanner.spec, tplanner.robot,
                tplanner.make_params(st, st, workspace_goal=target_all[rows]),
                torch.as_tensor(rest[rows], device=dev), sdf.contiguous(),
                tplanner.cfg).th)
    direct = torch.cat(direct)
    served = {name: torch.as_tensor(np.stack([q.th for q in resps]),
                                    device=dev)
              for name, resps in (("cold", cold), ("rested", rested))}
    shares = {name: tip_share(th) for name, th in served.items()}
    d_share = tip_share(direct)
    diff = float((served["rested"] - direct).abs().max())
    cold_diff = float((served["cold"] - served["rested"]).abs().max())
    print(f"(e) task-space arm, phase 8's problems 0..{2 * nb - 1}: tip "
          f"within 0.1 m of its target on {shares['rested']:.4f} of requests "
          f"seeded at rest (phase 8's gn.plan of the same problems "
          f"{d_share:.4f}, max |th difference| {diff:.3e}); on "
          f"{shares['cold']:.4f} served cold (the adapter's cold seed, the "
          f"arm at rest; max |th difference| from the rested plans "
          f"{cold_diff:.3e})")
    if (diff != 0.0 or shares["rested"] != d_share or cold_diff != 0.0
            or shares["cold"] != shares["rested"]):
        raise AssertionError(f"(e) task-space arm: served at rest {diff} "
                             f"from phase 8's plan, cold {cold_diff} from "
                             f"the rested plans, shares {shares} != "
                             f"{d_share}")
    profile_dispatch("(e) task-space arm", smi, svc,
                     make_arm(True)(nb, 42), n_arm)
    serve_stats("(e) task-space arm", smi, svc)


# Phase 15: 4 problems of each family through the dense oracle (float64,
# T=100; the 17-link arm's K alone would be gigabytes a problem), 20
# captured GN steps of the 2-D bench.
ORACLE_FAMILIES = ("2-D bench", "heading robot",
                   "GP interpolation + velocity limits", "2-link arm",
                   "task-space 3-link arm", "4-link arm", "9-link arm")
ORACLE_B, CAPTURE_STEPS, SHARD_PARTIAL = 4, 20, 200
ORACLE_TOL, ORACLE_SOLVE_TOL = 1e-10, 1e-9


def oracle_case(dev, name, planner, start, goal, wg, sdf):
    """15 (a) for one family: the first ORACLE_B problems in float64 at a
    perturbed straight line; relative errors of the block assembly and of
    the damped K-BTD solve against the dense oracle."""
    from dgpmp2_tpu_torch.core import dense, gn, graph
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.utils.tree import tree_map

    k = ORACLE_B
    spec, robot = planner.spec, planner.robot
    params = tree_map(torch.Tensor.double, planner.make_params(
        start[:k], goal[:k], workspace_goal=None if wg is None else wg[:k]))
    gen = torch.Generator(device=dev).manual_seed(15)
    th = seeds(spec, start[:k], goal[:k], dev, torch.float64)
    th = th + 0.1 * torch.randn(th.shape, generator=gen, dtype=th.dtype,
                                device=dev)
    sdf = sdf[:k].double().contiguous()
    out = {}

    def run():
        res = graph.eval_residuals(spec, robot, params, th, sdf)
        out["sys"] = graph.assemble_from_residuals(spec, params, res)
        out["dth"] = tridiag.btd_solve_auto(*gn.damped_system(*out["sys"],
                                                              0.1))
        out["dense"] = [dense.assemble_dense(
            spec, robot, tree_map(lambda x, i=i: x[i], params), th[i],
            sdf[i])
            for i in range(k)]

    # One lookup and one solve for the batch; one lookup a problem in the
    # oracle, two under GP interpolation.
    drive(f"15 (a) oracle {name}", run, {
        "btd_solve": 1,
        "sdf_lookup": 1 + k * (2 if spec.use_gp_inter else 1)})
    diag, off, rhs = out["sys"]
    errs = {"AtKA": 0.0, "AtKb": 0.0, "solve": 0.0}
    for i, (A, b, K) in enumerate(out["dense"]):
        atk = A.T @ K
        errs["AtKA"] = max(errs["AtKA"], rel_err(
            tridiag.btd_to_dense(diag[i], off[i]), atk @ A))
        errs["AtKb"] = max(errs["AtKb"], rel_err(rhs[i].reshape(-1),
                                                 atk @ b))
        errs["solve"] = max(errs["solve"], rel_err(
            out["dth"][i].reshape(-1), dense.solve_dense(A, b, K, 0.1)))
    m, n = spec.M, spec.N
    print(f"15 (a) {name}: D={spec.state_dim}, M={m}, N={n}, {k} problems "
          f"in float64; relative errors against the dense oracle "
          f"{json.dumps(errs)} (limits {ORACLE_TOL} / {ORACLE_SOLVE_TOL})")
    if not (errs["AtKA"] <= ORACLE_TOL and errs["AtKb"] <= ORACLE_TOL
            and errs["solve"] <= ORACLE_SOLVE_TOL):
        raise AssertionError(f"15 (a) {name}: {errs}")


def oracle(dev, bench_np):
    """15 (a): the dense oracle on the card, float64, each family at its
    path's own T=100 and robot."""
    imgs, start, goal = bench_np
    problems = constrained_problems(dev, bench_np)
    problems["2-D bench"] = (planner_from_yaml("2d", dev), start, goal, None,
                             occupancy_sdf(imgs[:ORACLE_B], dev))
    for name in ORACLE_FAMILIES:
        oracle_case(dev, name, *problems[name])
        torch.cuda.empty_cache()


def bench_paths(dev, bench_np):
    """Phase 5's bench trajectories: the float32 bench problem planned as
    phase 5 plans it (``core.gn.plan``, reg 0.1, 50 iterations)."""
    from dgpmp2_tpu_torch.core import gn

    bench = port_problem(*bench_np, dev, torch.float32)
    with torch.no_grad():
        out = gn.plan(*bench, gn.OptimConfig(reg=0.1, max_iters=50,
                                             tol_delta=0.0))
    return bench, out.th


def environments(dev, bench_np, paths):
    """15 (b): Env2D on a campaign forest world (128²) queried at phase 5's
    1024x101 trajectory points, Env3D on phase 6's 64³ world at its
    1024x101 straight-line seeds; each query equal to the plain lookup on
    the card bit for bit, transforms round-tripped, a slice of the 3-D
    field."""
    from dgpmp2_tpu_torch import envs
    from dgpmp2_tpu_torch.data import obstacles
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops

    forest = obstacles.make_map("forest", np.random.default_rng(15), IMSIZE)
    env2 = envs.Env2D({"x_lims": LIMS, "y_lims": LIMS}, device=dev)
    env2.initialize_from_image(forest)
    occ, start3, goal3 = bench3d_inputs(B, dev)
    env3 = envs.Env3D({"x_lims": LIMS, "y_lims": LIMS, "z_lims": LIMS},
                      device=dev)
    env3.initialize_from_voxels(occ[0].cpu().numpy())
    spec3 = planner_from_yaml("3d", dev).spec
    pts2 = paths[..., :2].contiguous()
    pts3 = seeds(spec3, start3, goal3, dev)[..., :3].contiguous()
    out = {}

    def run():
        out["2d"] = env2.get_signed_obstacle_distance(pts2)
        out["3d"] = env3.get_signed_obstacle_distance(pts3)
        out["feasible"] = [env2.is_feasible(p) for p in ((-4.5, -4.5),
                                                         (0.0, 0.0))]

    drive("15 (b) environments", run, {"sdf_lookup": 3, "sdf_lookup3d": 1})
    plain2 = sdf_ops.bilinear_lookup(env2.sedt[None],
                                     pts2.reshape(1, -1, 2), env2.res, LIMS,
                                     LIMS)
    plain3 = sdf_ops.trilinear_lookup(env3.sedt[None],
                                      pts3.reshape(1, -1, 3), env3.res,
                                      LIMS, LIMS, LIMS)
    for name, (d, g), (dp, gp), shape in (
            ("Env2D", out["2d"], plain2, pts2.shape),
            ("Env3D", out["3d"], plain3, pts3.shape)):
        if tuple(g.shape) != tuple(shape):
            raise AssertionError(f"15 (b) {name}: shape {tuple(g.shape)}")
        diff = max(float((d.reshape(-1) - dp.reshape(-1)).abs().max()),
                   float((g.reshape(-1) - gp.reshape(-1)).abs().max()))
        print(f"15 (b) {name}: {d.numel()} points, max |query - plain "
              f"lookup| {diff:.3e}, min distance {float(d.min()):.4f} m")
        if diff != 0.0 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"15 (b) {name}: {diff}")
    trips = {
        "Env2D pixel": float((env2.to_world(env2.to_pixel(pts2))
                              - pts2.double()).abs().max()),
        "Env3D voxel": float((env3.to_world(env3.to_voxel_xyz(pts3))
                              - pts3.double()).abs().max())}
    slices = []
    for z in (-4.0, 0.0, 3.3):
        sl = env3.slice_env2d(z)
        iz = int(round(-LIMS[0] / env3.res + z / env3.res))
        slices.append(torch.equal(sl.sedt, env3.sedt[iz])
                      and sl.sedt.device == env3.sedt.device)
    print(f"15 (b) round trips {json.dumps(trips)}; slices are the 3-D "
          f"field's {slices}; is_feasible {out['feasible']}")
    if max(trips.values()) > 1e-12 or not all(slices):
        raise AssertionError(f"15 (b): {trips} {slices}")


def capture(dev, smi, bench):
    """15 (c): CAPTURE_STEPS GN steps of the 2-D bench problem (B=1024,
    float32, reg 0.1) captured in one CUDA graph by
    ``utils.profiling.CapturedSteps``: the replay's th equals the eager
    steps bit for bit; ms per iteration captured (``time_compiled``) and
    eager."""
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.utils import profiling

    spec, robot, params, th0, sdf = bench
    delta = torch.tensor(0.1, dtype=th0.dtype, device=dev)

    def step(th, p, s):
        return th + gn.gn_step(spec, robot, p, th, s, delta)

    def eager():
        th = th0
        for _ in range(CAPTURE_STEPS):
            th = step(th, params, sdf)
        return th

    out = {}

    def run():
        with torch.no_grad():
            out["eager"] = eager()
            out["steps"] = profiling.CapturedSteps(
                step, th0, params, sdf, iters=CAPTURE_STEPS)
            out["replay"] = out["steps"].replay().clone()

    # One solve and one lookup a step: the eager steps, the warm-up step,
    # and the captured steps, counted at capture (where nothing runs) for
    # the one replay that runs them.
    n = 2 * CAPTURE_STEPS + 1
    drive("15 (c) capture", run, {"btd_solve": n, "sdf_lookup": n})
    per_replay = out["steps"].launches
    print(f"15 (c) one replay of the captured graph launches "
          f"{json.dumps(per_replay)} (counted once, at capture)")
    if per_replay != {**dict.fromkeys(KERNELS, 0),
                      "btd_solve": CAPTURE_STEPS,
                      "sdf_lookup": CAPTURE_STEPS}:
        raise AssertionError(f"15 (c) captured launches {per_replay}")
    diff = float((out["replay"] - out["eager"]).abs().max())
    finite = bool(torch.isfinite(out["replay"]).all())
    print(f"15 (c) {CAPTURE_STEPS} captured GN steps (B={B}) against the "
          f"eager steps: max |th difference| {diff:.3e}, finite {finite}")
    if diff != 0.0 or not finite:
        raise AssertionError(f"15 (c) capture: {diff}")
    with torch.no_grad():
        # Best (time_compiled's statistic) and median of 5 runs each.
        ms = {"captured": (
            profiling.time_compiled(step, th0, params, sdf,
                                    iters=CAPTURE_STEPS, repeats=5),
            cuda_ms(out["steps"].replay, reps=5, warmup=1) / CAPTURE_STEPS),
            "eager": (
            cuda_ms(eager, reps=5, warmup=1, best=True) / CAPTURE_STEPS,
            cuda_ms(eager, reps=5, warmup=1) / CAPTURE_STEPS)}
    for kind, (best, median) in ms.items():
        print(f"[{smi}] 15 (c) 2-D GN step B={B} T={T} float32, {kind}: "
              f"{best:.4f} ms per iteration best, {median:.4f} median, of 5 "
              f"runs of {CAPTURE_STEPS} steps")
    del out


def sharded_service(dev, smi):
    """15 (d): phase 14 (a)'s 2-D YAML planner at batch SERVE_B on a mesh
    of the one card, on a mesh of two entries of it (two shards of
    SERVE_B / 2 rows: the split, each shard's bank gather and the final
    gather at work) and on one of every visible card if there are more:
    SERVE_B requests by the bank, SERVE_B inline and SHARD_PARTIAL by the
    bank (the pad rows all in the last shard of two), equal to the
    unsharded service's bit for bit, launches shards × per dispatch ×
    dispatches; a batch the mesh does not divide is refused."""
    from dgpmp2_tpu_torch import serve
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    bench = bench_serve()
    planner = bench.make_planner(T, SERVE_ITERS, dev)
    world = bench.make_world(dev)
    bank = bench.make_requests(world, SERVE_B, 15)
    reqs = {"bank": bank,
            "inline": bench.make_requests(world, SERVE_B, 16, True),
            f"{SHARD_PARTIAL} by the bank": bank[:SHARD_PARTIAL]}
    plain = serve.PlanningService(planner, SERVE_B, SERVE_WINDOW_MS)
    plain.register_world("bench", world)
    want = {k: plain.plan_batch_sync(r) for k, r in reqs.items()}
    meshes = [("the one card", make_mesh([dev])),
              ("two entries of the one card", make_mesh([dev, dev]))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh()))
    print(f"15 (d) {torch.cuda.device_count()} CUDA device(s) visible")
    for label, mesh in meshes:
        svc = serve.PlanningService(planner, SERVE_B, SERVE_WINDOW_MS,
                                    mesh=mesh)
        svc.register_world("bench", world)
        svc.warmup()
        shards = len(mesh.data_devices())
        got = serve_drive(
            f"15 (d) sharded service, mesh of {label}", svc,
            lambda: {k: svc.plan_batch_sync(r) for k, r in reqs.items()},
            {"btd_solve": shards * SERVE_ITERS,
             "sdf_lookup": shards * (SERVE_ITERS + 1)})
        for kind, a in got.items():
            b = want[kind]
            same_th(f"15 (d) mesh of {label} ({shards} shards), {kind}, "
                    f"against the unsharded service", a, b)
            errs = max(max(abs(x.err_final - y.err_final),
                           abs(x.err_init - y.err_init)) for x, y in zip(a, b))
            if errs != 0.0 or [x.iters for x in a] != [y.iters for y in b]:
                raise AssertionError(f"15 (d) {label} {kind}: {errs}")
            check_responses(f"15 (d) mesh of {label}, {kind}", a,
                            [len(a) / SERVE_B] * len(a), SERVE_ITERS)
        serve_stats(f"15 (d) mesh of {label}", smi, svc)
    try:
        serve.PlanningService(planner, SERVE_B - 1, SERVE_WINDOW_MS,
                              mesh=make_mesh([dev, dev]))
    except ValueError as exc:
        print(f"15 (d) batch {SERVE_B - 1} on a mesh of two entries: "
              f"refused ({exc})")
    else:
        raise AssertionError("15 (d): a batch the mesh does not divide was "
                             "taken")


def oracle_envs_capture_mesh(dev, smi, bench_np):
    """Phase 15: (a) the dense oracle, (b) Env2D/Env3D, (c) a captured GN
    step (``utils.profiling``), (d) the service on a mesh."""
    phase("15 oracle, envs, capture, mesh")
    oracle(dev, bench_np)
    bench, paths = bench_paths(dev, bench_np)
    environments(dev, bench_np, paths)
    capture(dev, smi, bench)
    sharded_service(dev, smi)


def _leaves(tree, path=""):
    """(path, array) of each leaf of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


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
        "sdf_lookup_bwd": {
            "source": "dgpmp2_tpu_torch/csrc/sdf_lookup_bwd.cu",
            "replaces": "none: the JAX package replays XLA "
                        "(dgpmp2_tpu/ops/pallas/sdf_lookup.py:120 "
                        "_mxu_replay_bwd)"},
    }
    for name, rec in recs.items():
        rec.update(name=name, route="cuda")
    check_btd(dev, recs["btd_solve"], bench, smi)
    check_lookup(dev, recs["sdf_lookup"], bench, smi)
    check_lookup3d(dev, recs["sdf_lookup3d"], smi)
    lookups = path_lookups(dev)
    check_limbs(dev, recs["sdf_lookup_limbs"], smi, lookups)
    check_path_lookups(lookups)
    del lookups
    check_golden(dev)
    bench = main_path(dev, bench_np)
    bench3 = path3d(dev, smi)
    engines(bench)
    problems = constrained(dev, bench_np)
    ms_run = multistart(dev)
    per_iter = timing(smi, bench, bench3, problems, ms_run)
    learned(dev, bench_np)
    data = datagen(dev, smi)
    training(dev, smi, recs["sdf_lookup_bwd"], data)
    serving(dev, smi)
    oracle_envs_capture_mesh(dev, smi, bench_np)
    for name, rec in recs.items():
        rec["launches"] = TOTALS[name]
    for rec in recs.values():
        print(f"[{smi}] {rec['name']}: {times_line(rec)}")
    for key, ms in per_iter.items():
        print(f"[{smi}] gn_iter_ms_b1024{key} {ms:.4f}")
    for key, (value, n) in SERVE_METRICS.items():
        print(f"[{smi}] {key} {value:.4f} (n={n} requests)")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
