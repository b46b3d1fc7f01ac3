#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dgpmp2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

A plan whose launches are counted (:func:`counted`, so :func:`drive`) or
profiled (:func:`profile_run`) runs the eager loop (:func:`eager_plans`);
elsewhere ``core.gn.plan`` captures and replays its CUDA graph as for any
caller, and a timing loop of plans warms up twice, so its runs replay.

Phases, in order; any failed check raises, so the exit code is non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build the seven CUDA kernels from ``dgpmp2_tpu_torch/csrc`` with nvcc,
   printing every kernel's registers and spills (36 K-BTD instances: D = 1
   to 16, the wide kernel of D = 17-32 and the block kernel of D > 32, in
   two dtypes; 54 K-STREAM instances, the same shapes in three: float32,
   float64 and the df32 engine's mixed one), and K-STREAM's lane-group
   launch at B=1024 for every D from 1 to 16 and instance (producer warps,
   ring stages, registers, blocks an SM resident beside those the grid
   needs), and its wide and block launch plans at B=1024 (warps, stages,
   chunk rows, shared bytes, registers, blocks an SM) for the
   9- and 17-link arms' families and for phase 19 (a)'s random systems at
   D = 17-34, 40, 48, 64, 80: no K-STREAM instance may spill, and every
   block of each launch must be resident at once;
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
   split of the SDF into its packed limbs (once per plan); K-NORM (the
   learned encoder's LayerNorm, ReLU and max-pool) against the library
   chain at the first encoder block's shape (B=1024, 128x128x16, float32)
   and in float64 in 2-D and 3-D with its backward, then timed at each of
   the learned cell's five blocks and their sum.  Every kernel's
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
    steps; ms per iteration captured (``time_compiled``) and eager; then
    ``core.gn.plan`` of the bench four times (LM, ``track_best``): eager,
    captured, replayed, each bit-equal to the eager loop in every output,
    ``gn.graph_counts`` and ``gn.graph_launches`` read; (d)
    ``PlanningService(mesh=)`` with phase 14 (a)'s planner at batch 256 on
    a mesh of the one card, on a mesh of two entries of it (two shards of
    128 rows) and on one of every visible card when there are more: 256
    requests by the bank, 256 inline and 200 by the bank (56 pad rows, all
    in the last shard) bit-equal to the unsharded service; batch 255 on a
    mesh of two entries refused;
16. mesh execution, on entries of the one card: (a) the campaign's head
    (Linear 2250→1000→640→302, B=128) tensor-parallel over (1, 2) and
    (1, 4) meshes (``models.cov_head.TensorParallelHead``): forward and
    every gradient within 1e-12 of the replicated head in float64, the
    float32 gap stated; (b) one eps_bounded training step (B=128, 128²,
    T=100, unroll 10 in windows of 5) through ``make_train_step(mesh=)``
    on (2, 1) and (2, 2) meshes: in float64 (SGD, the head decoded in
    float64) metrics, every updated weight and gradient within 1e-10 of
    the unsharded step, the replicas bit-equal, launches the unsharded
    step's times the data shards; in float32 (Adam) ms per step, sharded
    and unsharded, median of 5; (c) two child processes of this script
    (``--mesh-process``), joined through gloo on the card
    (``make_multihost_mesh``, dcn = 2), each planning its 512 rows of the
    phase 5 bench through ``core.gn.plan`` and ``gather_batch``, against
    the one-process plan (float32 gap stated, float64 within 1e-10), then
    one float64 data-parallel training step at B=64 across them (the head
    split over two entries in each) within 1e-10 of the one-process step,
    the weights equal on both;
17. examples and scripts: every module of ``dgpmp2_tpu_torch.examples``
    (the port's counterparts of the JAX package's 21 ``examples/``) in
    process through its ``main()`` on the card at its default sizes,
    without ``--plot``, in the order of ``examples.EXAMPLES``: the counters
    zeroed before each and read after, ``core.gn.plan`` counted, and the
    launches of each kernel its path's own (K-BTD the counted GN
    iterations, and the adjoint solves under a gradient; K-LOOKUP the
    iterations + 1 a plan and the example's other lookups; K-LOOKUP3D only
    in ``plan3d_example``, K-LOOKUP-BWD only where a gradient flows);
    finite results, the example's own claims, every problem's error
    lowered (a warm replan below the straight seed's error); then the four
    ``dgpmp2_tpu_torch/scripts/*.sh`` in a chain through ``bash``
    (generate, train the initializer, train the planner, validate) at a
    reduced size (8 + 4 worlds at 128², T=100, 2 epochs), and
    ``report_stats_example`` on their results;
18. campaigns and sweeps: the eight modules of ``dgpmp2_tpu_torch.tools``
    (the port's counterparts of the JAX package's campaign and sweep
    tools) in process through their ``main()`` on the card in float32,
    into one temporary directory, at the tools' widths with depth cut
    (``campaigns``): the learned campaign (multi_obs and forest, 40 + 16
    worlds, 2 epochs, eps_bounded), the multistart sweep on its data (K=32
    pruned to 8, three sigmas; the learned pass on its checkpoint; forest
    with 2 RRT* seeds of 0.2 s), the init experiment on its forest data,
    the arm campaign (256 + 128 problems, 2 epochs) and its multistart
    evaluation, the 3-D sweep at its defaults (its rates printed beside the
    committed TPU run's, as quality), the 3-D learned campaign (16 + 16
    worlds, 2 epochs) and the headline chain at ``--scale smoke``.  For
    each run: wall s and launches by kernel (counters zeroed before, read
    after; K-BTD at least the counted ``gn.plan`` iterations, K-LOOKUP3D
    only in the 3-D tools, K-LOOKUP-BWD only where a tool trains,
    K-LOOKUP-LIMB never), its files, every YAML number finite and every
    rate in [0, 1], the YAML keys of the JAX tool's committed runs under
    ``runs/``, and a trained checkpoint reloaded through
    ``load_flat_variables`` planning bit-equal to the model in memory;
19. engines: stream and df32 (K-STREAM, ``csrc/btd_stream.cu``: one
    damped GN step, assembled from the residual pieces inside the
    block-Thomas sweeps).  (a) K-STREAM against its plain version on the
    first-iteration residuals of the 2-D and 3-D benches and of phase 8's
    heading robot, 2-link arm, task-space 3-link arm, GP interpolation with
    velocity limits, 4-, 9- and 17-link arms (D = 4, 6, 8, 18, 34), at
    B=1024 under GN and LM (a lambda per problem): the float64 instance
    within 1e-10 relative; the float32 instance within twice the standard
    float32 engine's error (assembly, damping, K-BTD) against the float64
    solve of the same float32 residuals, plus 1e-7; the mixed instance that
    float64 solve rounded to float32, within 1e-10 relative beyond half a
    float32 spacing; the same at B in {1, 1000} x T1 in {2, 41}; the
    lane-group kernel at every D from 1 to 16 in the three instances on
    random systems at its ring's edges (``stream_ring_edges``: B=1 with
    T1=1, B=7 with T1=2, and B=1000, a partly empty last block, with T1 one
    more than its stages), within the same bounds; the wide and block
    kernels (D = 17, 18, 32, 33, 34) at their stages' and chunks' edges
    (``stream_rows_edges``: T1 in {1, 2, stages + 1}, a diagonal family of
    K in {1, chunk - 1, chunk, chunk + 1, 411} rows beside a shared and a
    per-problem full Λ, every addend, B in {1, 7, 1000}, under the default
    plan and under 2 stages of 16 rows); the df32
    step on ``tests/goldens/golden_ref_step.npz`` (env 1, 12 iterates
    along the float64 path) within 1e-4 of the float64 step and 2x the
    floor.  (b) The bench problem through ``DiffGPMP2Planner.plan`` from
    the YAMLs with ``engine`` stream, then df32, 100 iterations, and the
    3-D bench with stream: one K-STREAM launch a GN iteration and no K-BTD
    launch, 95 % of problems improved; launches and device busy per
    iteration (profiler) and ms per iteration (CUDA events, host-paced) of
    the standard, stream and df32 engines; then phase 8's 9- and 17-link
    arms (LM, 20 iterations, B=1024, float32) under stream and df32, one
    K-STREAM launch an iteration, every problem improved, their ms and
    device busy per iteration beside the standard engine's.  (c)
    K-STREAM's three instances
    timed at the 2-D and 3-D benches and at the 4-, 9- and 17-link arms
    (D = 8, 18, 34: the lane-group, wide and block kernels) beside the
    standard engine's assembly + damping + K-BTD for the same step.  (d) The
    float64 gradient of a
    5-iteration stream plan (B=64) with respect to ``obs_inv`` and
    ``q_inv`` on the card within 1e-10 of the CPU's.

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
import os
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
CONFIGS = ROOT / "dgpmp2_tpu_torch" / "configs"
B, T, IMSIZE, VOX = 1024, 100, 128, 64
LIMS = (-5.0, 5.0)
KERNELS = ("btd_solve", "sdf_lookup", "sdf_lookup3d", "sdf_lookup_limbs",
           "sdf_lookup_bwd", "btd_stream", "encoder_norm")
# K-NORM launches of one forward of the learned encoder on the card, one a
# block (models/conv_encoder.FEATURES); its backward launches as many again.
NORMS = 5


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
    # K-BTD's instances (BTD_INSTANCES) in two dtypes; each D of K-STREAM's
    # narrow kernel, its wide and its block kernel in three instances
    # (float32, float64 and the df32 engine's mixed one).
    for kernel, label, want in (("btd_solve_kernel", "K-BTD",
                                 2 * BTD_INSTANCES),
                                ("btd_stream_kernel", "K-STREAM",
                                 3 * (BTD_NARROW + 2))):
        n = sum(kernel in r[0] for r in rows)
        if n != want:
            raise AssertionError(f"ptxas reported {n} {label} kernels, not "
                                 f"{want}")
    check_btd_plans(rows, torch.device("cuda", 0))
    check_stream_plans(rows)
    check_rows_plans(rows)


# K-BTD's plans phase 2 prints: every D of the wide kernel and the block
# kernel's first two, the arms of 20, 24 and 32 links, and the largest D in
# shared memory.
BTD_PLAN_D = (*range(17, 35), 40, 48, 64)


def check_btd_plans(rows, dev, b=B):
    """K-BTD's wide and block launch plans at batch ``b`` in both dtypes
    (``ops/cuda/btd_solve.geometry``: the kernel library's own plan):
    threads, registers, shared bytes, blocks an SM
    resident beside those the grid puts there, problems a block; raises on
    a spill of any K-BTD instance (ptxas or the kernel's local memory) or a
    block that would wait for another (the wide and block grids are
    persistent: a plan holds this by its making)."""
    from dgpmp2_tpu_torch.ops.cuda import btd_solve

    bad = [(kernel_name(n), st, ld) for n, _, st, ld, _ in rows
           if kernel_name(n).startswith("btd_solve_kernel") and (st or ld)]
    top = btd_smem_max(btd_solve, dev)
    for dtype in (torch.float32, torch.float64):
        for d in BTD_PLAN_D + (top,):
            g = btd_solve.geometry(d, b, dtype, dev)
            print(f"K-BTD {dtype} D={d} B={b} ({g['regime']} kernel, "
                  f"instance {g['instance']}): {g['threads']} threads, "
                  f"{g['registers']} registers, {g['local_bytes']} B local, "
                  f"{g['smem_bytes']} B shared (staged one step ahead); "
                  f"{g['resident_blocks_per_sm']} blocks an SM resident, "
                  f"{g['needed_blocks_per_sm']} placed ({g['grid']} blocks, "
                  f"{g['problems_per_block']} problems a block, {g['sms']} "
                  f"SMs)")
            if (g["local_bytes"] or g["resident_blocks_per_sm"]
                    < g["needed_blocks_per_sm"]):
                bad.append((str(dtype), d, g))
    if bad:
        raise AssertionError(f"K-BTD instances that spill or plans that "
                             f"leave blocks waiting: {bad}")


# The wide and block kernels' plans phase 2 checks besides the arms': D of
# phase 19 (a)'s random systems (stream_system's families).
ROWS_PLAN_D = (*range(17, 35), 40, 48, 64, 80)


def arm_family_shapes(links):
    """K-STREAM's families of a planar arm of ``links`` (two spheres a
    link, as phase 8's): obstacles and joint limits with full Λs and the
    self-collision pairs with a diagonal one, every Λ shared."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream
    from dgpmp2_tpu_torch.robots import PlanarArmNLink, self_collision_pairs

    arm = PlanarArmNLink(link_lengths=tuple(links), spheres_per_link=2,
                         sphere_radii=(0.25,))
    fs = btd_stream.FamilyShape
    return (fs(arm.nlinks, False, True), fs(len(links), False, True),
            fs(len(self_collision_pairs(arm)), True, True))


def check_stream_plans(rows, b=B):
    """K-STREAM's lane-group launch at batch ``b`` for every D <= 16 in its
    three instances: producer warps, stages, registers and blocks an SM
    resident beside those needed; raises on a spill (ptxas or the kernel's
    local memory) or on a block that would wait for another."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream

    bad = [(kernel_name(n), st, ld) for n, _, st, ld, _ in rows
           if kernel_name(n).startswith("btd_stream_kernel<") and (st or ld)]
    for kind in ("f32", "f64", "mixed"):
        for d in range(1, BTD_NARROW + 1):
            g = btd_stream.geometry(d, b, kind)
            print(f"K-STREAM {kind} D={d} B={b}: {g['producers']} producer "
                  f"warps, {g['stages']} stages, {g['smem_bytes']} B shared, "
                  f"{g['registers']} registers, {g['local_bytes']} B local; "
                  f"{g['resident_blocks_per_sm']} blocks an SM resident, "
                  f"{g['needed_blocks_per_sm']} needed ({g['grid']} blocks, "
                  f"{g['sms']} SMs)")
            if (g["local_bytes"] or g["resident_blocks_per_sm"]
                    < g["needed_blocks_per_sm"]):
                bad.append((kind, d, g))
    if bad:
        raise AssertionError(f"K-STREAM lane-group instances that spill or "
                             f"leave blocks waiting: {bad}")


def check_rows_plans(rows, b=B):
    """K-STREAM's wide and block launch plans at batch ``b`` in its three
    instances, for the 9- and 17-link arms' families and for
    :data:`ROWS_PLAN_D` (stream_system's families): warps, stages, chunk
    rows, shared bytes, registers and blocks an SM resident
    beside those needed; raises on a spill (ptxas or the kernel's local
    memory) or on a block that would wait for another (the grid is
    persistent: a plan holds this by its making)."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream

    bad = [(kernel_name(n), st, ld) for n, _, st, ld, _ in rows
           if kernel_name(n).startswith(("btd_stream_kernel_wide",
                                         "btd_stream_kernel_block"))
           and (st or ld)]
    fs = btd_stream.FamilyShape
    random_fams = (fs(3, False, True), fs(2, True, False))
    plans = [(f"{n}-link arm", 2 * len(links), arm_family_shapes(links))
             for n, links in ((9, ARM9_LINKS), (17, arm17_links()))]
    plans += [("random system", d, random_fams) for d in ROWS_PLAN_D]
    for kind in ("f32", "f64", "mixed"):
        for label, d, fams in plans:
            g = btd_stream.geometry(d, b, kind, families=fams)
            print(f"K-STREAM {kind} {label} D={d} B={b} ({g['kernel']}): "
                  f"{g['warps']} warps ({g['formers']} formers), "
                  f"{g['stages']} stages of {g['chunk_rows']} rows "
                  f"({g['stage_bytes']} B), "
                  f"{g['kept']} Λ kept, {g['smem_bytes']} B shared"
                  f"{', rows in scratch' if g['scratch_block'] else ''}, "
                  f"{g['registers']} registers, {g['local_bytes']} B local; "
                  f"{g['resident_blocks_per_sm']} blocks an SM resident, "
                  f"{g['needed_blocks_per_sm']} needed ({g['grid']} blocks "
                  f"of {g['problems_per_block']} problems, {g['sms']} SMs)")
            if (g["local_bytes"] or g["resident_blocks_per_sm"]
                    < g["needed_blocks_per_sm"]):
                bad.append((kind, label, d, g))
    if bad:
        raise AssertionError(f"K-STREAM wide and block instances that spill "
                             f"or leave blocks waiting: {bad}")


def kernel_name(mangled):
    """``btd_solve_kernel<float, 4>``-style name of a mangled kernel."""
    for m in re.finditer(r"(?=(\d+)([a-z_]\w*))", mangled):
        n, ident = int(m[1]), m[2][:int(m[1])]
        if (len(ident) == n and "_kernel" in ident
                and ident.rsplit("_kernel", 1)[1] in ("", "_wide", "_block",
                                                      "_scratch")):
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


def device_ms(fn, kernel, reps=20, graph_n=100):
    """Device-only ms of one launch: ``torch.profiler``'s self device time
    of the kernels whose name holds ``kernel``, over ``reps`` calls of
    ``fn`` (one launch each), each after the L2 flush, divided by their
    launch count.  The profiler may drop a few launches' records; a window
    that shows fewer than ``reps`` is taken again, up to three times, and
    the last one used if it shows any; if none shows a launch, the
    CUDA-graph replay's time (:func:`graph_ms` of ``graph_n`` calls) stands
    in, said so."""
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
        # Windows in which the profiler records no kernel at all (seen for
        # K-LOOKUP-LIMB, and for most of phase 19's K-STREAM timings late
        # in the whole script on an H100): the CUDA-graph replay's time,
        # warm L2, instead.
        ms = graph_ms(fn, n=graph_n)
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


def kernel_ms(record, kernel, plain, name, plain_reps=5, reps=20,
              graph_n=100, host_n=1000):
    """A kernel's times into ``record``: ``ms`` device-only (profiler, L2
    flushed), ``graph_ms`` (CUDA graph, warm L2), ``event_ms`` (CUDA events
    around one call after the flush: host-inclusive), ``host_us`` per
    wrapper call, and, unless ``plain`` is None, ``plain_ms`` of its plain
    version (events, flushed).  ``reps`` profiled and event runs, a graph
    of ``graph_n`` calls, ``host_n`` host calls: fewer for a kernel of
    milliseconds (:data:`ARM_TIMING`)."""
    record["ms"] = device_ms(kernel, name, reps, graph_n)
    record["graph_ms"] = graph_ms(kernel, n=graph_n)
    record["event_ms"] = cuda_ms(kernel, reps=reps, flush=True)
    record["host_us"] = host_us(kernel, n=host_n)
    if plain is not None:
        record["plain_ms"] = cuda_ms(plain, reps=plain_reps, flush=True)


def profile_plan(bench, cfg):
    """``gn.plan(*bench, cfg)`` under :func:`profile_run`."""
    from dgpmp2_tpu_torch.core import gn

    return profile_run(lambda: gn.plan(*bench, cfg))


@contextlib.contextmanager
def eager_plans():
    """Every ``core.gn.plan`` inside the block runs the eager loop, on any
    thread: no CUDA graph is captured or replayed (a replay's kernels are
    counted in ``gn.graph_launches``, not by the kernel wrappers)."""
    from dgpmp2_tpu_torch.core import gn

    device, gn._GRAPH_DEVICE = gn._GRAPH_DEVICE, None
    try:
        yield
    finally:
        gn._GRAPH_DEVICE = device


def profile_run(run, eager=True):
    """``run()`` once under ``torch.profiler``, after a warm-up, its plans
    the eager loop (:func:`eager_plans`; with ``eager`` false, the path
    ``core.gn.plan`` takes for any caller): the profiler, and a record of
    the wall ms, the device-busy ms, the device operations and, for each of
    the port's kernels that ran, its launches, device µs per launch and
    share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    with eager_plans() if eager else contextlib.nullcontext():
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
# K-BTD's instances of a dtype: the lane group's D = 1-16, the wide kernel's
# four register widths, the block kernel and the global-scratch kernel.
BTD_INSTANCES = BTD_NARROW + 4 + 1 + 1
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
# The block kernel at the arms' T, for tools/time_kernels.py --btd: D=33,
# a 17-link arm's D=34, and a 32-link arm's D=64.
BTD_BLOCK_TIMED = tuple((f"D={d} arm", B, 41, d, dtype) for d in (33, 34, 64)
                        for dtype in (torch.float32, torch.float64))
# NVIDIA's H100 SXM data sheet: HBM3 rate, and the dense peaks of each type
# (float32 67 TFLOP/s outside the tensor cores; float64 67 TFLOP/s on the
# FP64 tensor cores, 34 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def btd_flops(t, d):
    """The fewest operations that solve one problem's block-tridiagonal
    system of ``t`` steps of ``d``: per step a Cholesky of C_t (D³/3) and
    the two triangular solves of z_t and x_t (2D²); per coupling the solve
    W = L⁻¹U (D³), the symmetric Schur update of C's lower triangle
    (D³), and the products Wᵀz and W x (4D²)."""
    return t * (d ** 3 / 3 + 2 * d * d) + (t - 1) * (2 * d ** 3 + 4 * d * d)


def btd_bound(b, t, d, dtype):
    """K-BTD reads diag, off and rhs once and writes x once, and does
    :func:`btd_flops` a problem."""
    sz = torch.finfo(dtype).bits // 8
    nbytes = sz * (b * t * d * d + b * (t - 1) * d * d + 2 * b * t * d)
    return bound(nbytes, b * btd_flops(t, d), dtype)


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


def btd_digests(dev) -> dict:
    """sha256 of K-BTD's output on each of phase 3's systems, drawn in phase
    3's order (check_btd, then check_btd_block): two trees' K-BTD held
    bit-equal (``tools/time_kernels.py --btd-digest``)."""
    import hashlib

    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    rng = np.random.default_rng(1)
    out = {}

    def digest(name, system):
        x = k.launch(*system).cpu().numpy()
        out[name] = hashlib.sha256(x.tobytes()).hexdigest()

    for dtype in (torch.float32, torch.float64):
        for d in BTD_D:
            t = T + 1 if d <= 8 else 41
            digest(f"{dtype} D={d} B={B} T={t}",
                   spd_system(rng, B, t, d, dtype, dev))
            for b, te in BTD_EDGES:
                digest(f"{dtype} D={d} B={b} T={te}",
                       spd_system(rng, b, te, d, dtype, dev))
    for label, b, t, d, dtype in BTD_TIMED + BTD_WIDE_TIMED:
        digest(f"{label} {dtype} D={d} B={b} T={t}",
               spd_system(rng, b, t, d, dtype, dev))
    top = btd_smem_max(k, dev)
    for dtype in (torch.float32, torch.float64):
        for d in BTD_BLOCK_D + (top, top + 1):
            digest(f"block {dtype} D={d}", spd_system(rng, B, 41, d, dtype,
                                                      dev))
    return out


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


def first_system(bench):
    """The damped (reg = 0.1) system of a problem's first GN iteration."""
    from dgpmp2_tpu_torch.core import gn, graph

    spec, robot, params, th0, sdf = bench
    res = graph.eval_residuals(spec, robot, params, th0, sdf)
    return [a.contiguous() for a in gn.damped_system(
        *graph.assemble_from_residuals(spec, params, res), 0.1)]


# The arms whose systems take K-BTD's wide (D = 18) and block (D = 34)
# kernels, timed on their own first-iteration systems in phase 3.
BTD_ARMS = ("9-link arm", "17-link arm")


def check_btd_arms(dev, smi, bench_np):
    """K-BTD on phase 8's 9- and 17-link arms' own first-iteration systems
    (float32, B=1024, T=41): held as :func:`check_btd_bench_system` holds
    the bench's, then timed beside the bound, the plain version and
    ``torch.linalg.solve`` on the dense (B, T·D, T·D) Λ (2.2 and 8.0 GB),
    with the launch plan."""
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    problems = constrained_problems(dev, bench_np)
    for name in BTD_ARMS:
        bench = problem_of(*problems[name])
        check_btd_bench_system(name, bench)
        diag, off, rhs = first_system(bench)
        b, t, d = rhs.shape
        rec = {}
        kernel_ms(rec, lambda: k.launch(diag, off, rhs),
                  lambda: tridiag.btd_solve(diag, off, rhs),
                  "btd_solve_kernel", plain_reps=3, **ARM_TIMING)
        rec["bound_ms"], rec["bound_by"] = btd_bound(b, t, d, diag.dtype)
        g = k.geometry(d, b, diag.dtype)
        try:
            lam, r = dense_lambda(diag, off), rhs.reshape(b, t * d, 1)
            lib = cuda_ms(lambda: torch.linalg.solve(lam, r), reps=2,
                          warmup=1)
            lib = f"{lib:.4f} ms"
        except torch.cuda.OutOfMemoryError:
            lib = "did not fit the card"
        lam = r = None
        torch.cuda.empty_cache()
        print(f"[{smi}] K-BTD {name}'s first-iteration system B={b} T={t} "
              f"D={d} {diag.dtype} ({g['regime']} kernel, {g['threads']} "
              f"threads, {g['resident_blocks_per_sm']} blocks an SM, "
              f"{g['problems_per_block']} problems a block): "
              f"{times_line(rec)}; torch.linalg.solve on the dense Λ {lib}")
        del bench, diag, off, rhs
    del problems
    torch.cuda.empty_cache()


def check_btd_bench_system(name, bench):
    """K-BTD on a bench problem's own first-iteration system (damped,
    reg = 0.1).  Its conditioning is set by K_s⁻¹ = 1e4 and the GP's
    12/dt³ = 1.2e4, so float32 loses digits in any solver.  Held: the
    kernel's float32 error against the float64 solve is within 4x the plain
    version's (+1e-6 relative), and the float64 kernel agrees with the
    float64 plain version to 1e-9."""
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

    diag, off, rhs = first_system(bench)
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


# K-NORM at the learned cell's five encoder blocks, B=1024: (input spatial
# shape, channels, pooled) of each block's LayerNorm, ReLU and max-pool.
ENCODER_BLOCKS = (((128, 128), 16, True), ((64, 64), 16, True),
                  ((32, 32), 16, True), ((16, 16), 32, True),
                  ((8, 8), 32, False))


def encoder_norm_bound(b, spatial, c, pool, dtype):
    """K-NORM reads the block's input and the scales and offsets once and
    writes its output once; ~8 operations an input value (the mean's add,
    the variance's subtract and fma, the affine's multiply and fma, the
    max)."""
    n_in = b * int(np.prod(spatial)) * c
    n_out = b * int(np.prod([s // 2 if pool else s for s in spatial])) * c
    sz = torch.finfo(dtype).bits // 8
    return bound(sz * (n_in + n_out + 2 * c), 8 * n_in, dtype)


def encoder_norm_inputs(dev, b, spatial, c, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, *spatial, c, generator=g, device=dev, dtype=dtype)
    w = 1.0 + 0.3 * torch.randn(c, generator=g, device=dev, dtype=dtype)
    bias = 0.3 * torch.randn(c, generator=g, device=dev, dtype=dtype)
    return x, w, bias


def check_encoder_norm(dev, record, smi):
    """K-NORM against its plain version (the library chain ``F.layer_norm``
    → ``torch.relu`` → ``max_pool2d``/``3d``) on the card: float64 and 3-D
    at small shapes, the backward against the chain's autograd there; then
    at each of the learned cell's five blocks in float32, B=1024, the
    output held to the chain's and timed (device-only, L2 flushed) beside
    its bound and the chain's time, the five summed: the encoder's whole
    norm stage; then the backward at the training batch
    (:func:`encoder_norm_backward`)."""
    from dgpmp2_tpu_torch.models.conv_encoder import LN_EPS
    from dgpmp2_tpu_torch.ops.cuda import encoder_norm as k

    errs = {}
    for label, shp, c2, pool2 in (("float64 2-D", (7, 33, 31), 32, True),
                                  ("float64 3-D", (3, 9, 8, 7), 16, True),
                                  ("float64 last block", (5, 8, 8), 32,
                                   False)):
        a = (*encoder_norm_inputs(dev, shp[0], shp[1:], c2, torch.float64),
             pool2, LN_EPS)
        errs[label] = norm_err(k.launch(*a), k.plain(*a))
        ins = [t.clone().requires_grad_(True) for t in a[:3]]
        ref = [t.clone().requires_grad_(True) for t in a[:3]]
        go = torch.randn(k.plain(*a).shape, device=dev, dtype=torch.float64)
        k.norm_relu_pool(*ins, *a[3:]).backward(go)
        k.plain(*ref, *a[3:]).backward(go)
        errs[f"{label} backward"] = max(norm_err(u.grad, v.grad)
                                        for u, v in zip(ins, ref))
    print(f"[{smi}] K-NORM against the library chain, max error over max "
          f"|value|: {json.dumps(errs)} (tol 1e-10)")
    if max(errs.values()) > 1e-10:
        raise AssertionError(f"K-NORM off its plain version: {errs}")

    b = B
    stage = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
    worst = 0.0
    for i, (spatial, c, pool) in enumerate(ENCODER_BLOCKS):
        a = (*encoder_norm_inputs(dev, b, spatial, c, torch.float32), pool,
             LN_EPS)
        err = norm_err(k.launch(*a), k.plain(*a))
        rec = {}
        kernel_ms(rec, lambda: k.launch(*a), lambda: k.plain(*a),
                  "encoder_norm_kernel")
        rec["bound_ms"], rec["bound_by"] = encoder_norm_bound(
            b, spatial, c, pool, torch.float32)
        print(f"[{smi}] K-NORM block {i + 1} B={b} {spatial}x{c} "
              f"{'pooled' if pool else 'no pool'} float32: max error over "
              f"max |value| {err:.3e} against the library chain (tol 1e-5); "
              f"{times_line(rec)} (the plain version is the library chain)")
        if not err <= 1e-5:
            raise AssertionError(f"K-NORM block {i + 1} off the library "
                                 f"chain: {err}")
        worst = max(worst, err)
        for key in stage:
            stage[key] += rec[key]
        if i == 0:
            record.update(rec, library_ms=rec["plain_ms"])
        del a
    record["max_abs_err"] = worst
    print(f"[{smi}] K-NORM the encoder's five blocks, B={b} float32: "
          f"device-only {stage['ms']:.4f} ms, bound {stage['bound_ms']:.4f} "
          f"ms (bytes), share of bound {stage['bound_ms'] / stage['ms']:.4f}; "
          f"library chain {stage['plain_ms']:.4f} ms")
    record["stage"] = stage
    record["backward"] = encoder_norm_backward(dev, smi)


def norm_err(got, want):
    """Largest difference over the largest |value| of ``want`` (1 at
    least)."""
    return float((got - want).abs().max() / max(1.0, float(
        want.abs().max())))


def near_ties(dx, dx_ref, x, w, bias, pool):
    """(largest difference of ``dx`` from ``dx_ref`` over max |dx_ref|
    outside the near ties, the near ties where they differ by more than
    1e-5 of it): a near tie is a 2×2 window of a pooled 2-D block where, in
    some channel, the two largest values after the chain's LayerNorm and
    ReLU are positive and within 8 float32 ulps of each other, so that the
    kernel's rounding and the chain's may each make another pixel the
    max."""
    from dgpmp2_tpu_torch.models.conv_encoder import LN_EPS

    diff = (dx - dx_ref).abs() / max(1.0, float(dx_ref.abs().max()))
    if not pool:
        return float(diff.max()), 0

    def windows(a):  # (B, H, W, C) -> (B, H/2, W/2, C, 4)
        b, h, w_, c = a.shape
        a = a[:, :h // 2 * 2, :w_ // 2 * 2]
        return a.reshape(b, h // 2, 2, w_ // 2, 2, c).permute(
            0, 1, 3, 5, 2, 4).reshape(b, h // 2, w_ // 2, c, 4)

    y = torch.relu(torch.nn.functional.layer_norm(x, (x.shape[-1],), w,
                                                  bias, LN_EPS))
    top = windows(y).topk(2, dim=-1).values
    # A pixel's LayerNorm backward mixes its channels: a window at a time.
    near = ((top[..., 0] > 0) & (top[..., 0] - top[..., 1] <= 8 * torch.finfo(
        y.dtype).eps * top[..., 0])).any(-1)
    worst = windows(diff).amax((-2, -1))
    moved = int(((worst > 1e-5) & near).sum())
    return float(worst.masked_fill(near, 0.0).max()), moved


def encoder_norm_backward(dev, smi, b=None):
    """K-NORM's backward at the training step's batch (``TRAIN_B``) at each
    of the five blocks in float32: its kernel device-only (profiler, L2
    flushed) beside its bound by bytes (it reads the block's input and the
    output's cotangent, and writes the input's), and the whole backward as
    training runs it (``torch.autograd.grad`` through
    :func:`~dgpmp2_tpu_torch.ops.cuda.encoder_norm.norm_relu_pool`: the
    kernel and the sum of its scale and offset partials) beside the library
    chain's autograd backward, both by CUDA events with the L2 flushed and
    the forward's graph kept.  The input's cotangent is held to the
    chain's at 1e-5 outside the windows :func:`near_ties` finds, where a
    float32 rounding decides which pixel takes the window's cotangent; the
    scale's and offset's are reported (the float64 check holds them).
    Returns the five blocks' sums."""
    from dgpmp2_tpu_torch.models.conv_encoder import LN_EPS
    from dgpmp2_tpu_torch.ops.cuda import encoder_norm as k

    b = b or TRAIN_B
    sums = {"ms": 0.0, "bound_ms": 0.0, "autograd_ms": 0.0,
            "library_ms": 0.0}
    for i, (spatial, c, pool) in enumerate(ENCODER_BLOCKS):
        x, w, bias = encoder_norm_inputs(dev, b, spatial, c, torch.float32,
                                         seed=i + 1)
        ins = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        ref = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        out = k.norm_relu_pool(*ins, pool, LN_EPS)
        want = k.plain(*ref, pool, LN_EPS)
        go = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(i), dtype=torch.float32)

        def grads():
            return torch.autograd.grad(out, ins, go, retain_graph=True)

        def chain():
            return torch.autograd.grad(want, ref, go, retain_graph=True)

        (dx, *dp), (dx_ref, *dp_ref) = grads(), chain()
        err, moved = near_ties(dx, dx_ref, x, w, bias, pool)
        err_p = max(norm_err(u, v) for u, v in zip(dp, dp_ref))
        rec = {"ms": device_ms(lambda: k.launch_backward(
                   x, w, bias, go, pool, LN_EPS), "encoder_norm_bwd_kernel"),
               "autograd_ms": cuda_ms(grads, reps=10, flush=True),
               "library_ms": cuda_ms(chain, reps=10, flush=True)}
        n_in, n_out = x.numel(), go.numel()
        rec["bound_ms"], by = bound(4 * (2 * n_in + n_out + 4 * c),
                                    16 * n_in, torch.float32)
        print(f"[{smi}] K-NORM backward block {i + 1} B={b} {spatial}x{c} "
              f"{'pooled' if pool else 'no pool'} float32: kernel "
              f"device-only {rec['ms']:.4f} ms (profiler, L2 flushed), "
              f"bound {rec['bound_ms']:.4f} ms ({by}), share of bound "
              f"{rec['bound_ms'] / rec['ms']:.4f}; autograd backward "
              f"{rec['autograd_ms']:.4f} ms against the library chain's "
              f"{rec['library_ms']:.4f} ms (events, L2 flushed); the "
              f"input's cotangent max error over max |value| {err:.3e} "
              f"outside near ties (tol 1e-5), {moved} near-tie windows "
              f"routed to another pixel; the scale's and offset's "
              f"{err_p:.3e} (reported)")
        if not err <= 1e-5:
            raise AssertionError(f"K-NORM backward block {i + 1} off the "
                                 f"library chain: {err}")
        for key in sums:
            sums[key] += rec[key]
        del x, ins, ref, out, want, go
    print(f"[{smi}] K-NORM backward, the encoder's five blocks, B={b} "
          f"float32: kernel device-only {sums['ms']:.4f} ms, bound "
          f"{sums['bound_ms']:.4f} ms, share of bound "
          f"{sums['bound_ms'] / sums['ms']:.4f}; autograd backward "
          f"{sums['autograd_ms']:.4f} ms against the library chain's "
          f"{sums['library_ms']:.4f} ms")
    return sums


def encoder_norm_alone(dev, smi):
    """Phase 3's K-NORM check alone: ``python3 -c 'import torch, chip_smoke
    as cs; smi = cs.device_info(); cs.encoder_norm_alone(torch.device(
    "cuda", 0), smi)'`` (the library is built at the first launch)."""
    phase("3 K-NORM alone")
    rec = {}
    check_encoder_norm(dev, rec, smi)
    print(json.dumps({"encoder_norm": rec}))


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
    from dgpmp2_tpu_torch.ops.cuda import (btd_solve, btd_stream,
                                           encoder_norm, sdf_lookup,
                                           sdf_lookup3d, sdf_lookup_bwd,
                                           sdf_lookup_limbs)

    return dict(zip(KERNELS, (btd_solve, sdf_lookup, sdf_lookup3d,
                              sdf_lookup_limbs, sdf_lookup_bwd, btd_stream,
                              encoder_norm)))


# Launches of every path run through drive(), by kernel: the kernels line;
# K-BTD's by regime (ops/cuda/btd_solve.REGIMES), as each path's counters
# read them.
TOTALS = dict.fromkeys(KERNELS, 0)
BTD_REGIMES = ("lane", "wide", "block", "scratch")
REGIME_TOTALS = dict.fromkeys(BTD_REGIMES, 0)


def counted(run, mods, dev=None):
    """``run()``, its plans the eager loop (:func:`eager_plans`), with the
    launch counters of ``mods`` (:func:`counters`), K-BTD's by regime, set
    to 0 just before and read just after, on ``dev`` (synchronized where
    it is a card): (its output, the counts, K-BTD's launches by regime)."""
    cuda = dev is None or dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    mods["btd_solve"].regime_launches = dict.fromkeys(BTD_REGIMES, 0)
    with eager_plans():
        out = run()
    if cuda:
        torch.cuda.synchronize()
    return (out, {k: m.launches for k, m in mods.items()},
            dict(mods["btd_solve"].regime_launches))


def launch_counts(run):
    """``run()`` through :func:`counted` with every kernel's counter, and
    K-LOOKUP-LIMB's count of SDF splits ("limb_splits"), set to 0 just
    before and read just after: (its output, the counts, K-BTD's launches
    by regime)."""
    mods = counters()
    limbs = mods["sdf_lookup_limbs"]
    limbs.splits = 0
    out, counts, regimes = counted(run, mods)
    counts["limb_splits"] = limbs.splits
    return out, counts, regimes


def add_totals(counts, regimes):
    """Add one path's counts, and K-BTD's launches by regime as its
    counters read them, to the kernels line's; the regimes must sum to
    K-BTD's count."""
    if sum(regimes.values()) != counts["btd_solve"]:
        raise AssertionError(f"K-BTD launches by regime {regimes} do not "
                             f"sum to {counts['btd_solve']}")
    for k in KERNELS:
        TOTALS[k] += counts[k]
    for k, n in regimes.items():
        REGIME_TOTALS[k] += n


def drive(name, run, want):
    """Run one path through :func:`launch_counts`; the counts must equal
    ``want`` (absent keys: 0), or ``want(out)`` where the count depends on
    the path's output."""
    out, counts, regimes = launch_counts(run)
    want = want(out) if callable(want) else want
    want = {k: want.get(k, 0) for k in counts}
    print(f"{name} launches {json.dumps(counts)}, expected {json.dumps(want)}")
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    add_totals(counts, regimes)
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


# The 9-link arm's links (0.6 down to 0.3 m, 3.8 m in all).
ARM9_LINKS = (0.6, 0.5, 0.5, 0.45, 0.4, 0.4, 0.35, 0.3, 0.3)


def arm17_links():
    """The 17-link arm's links: the 9-link arm's profile resampled at 17
    links and scaled to the same 3.8 m."""
    links = np.interp(np.linspace(0, 8, 17), np.arange(9), ARM9_LINKS)
    return (links * 3.8 / links.sum()).tolist()


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
    links = list(ARM9_LINKS)
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
    links17 = arm17_links()
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
    CUDA-event runs after two warm-ups (a ``core.gn.plan`` key's second
    plan captures its graph: the runs replay it)."""
    t50, t200 = (cuda_ms(lambda: run(n), reps=5, warmup=2) for n in (50, 200))
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
        ms = cuda_ms(lambda: ms_run(name), reps=5, warmup=2)
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
    track_best), one more per multistart scoring, the encoder's NORMS
    K-NORM launches a plan (two plans when staged); then the gradient check
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
        ff, track_best=True), {"btd_solve": n, "sdf_lookup": n + 1,
                               "encoder_norm": NORMS})
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
                   {"btd_solve": n, "sdf_lookup": n + 1,
                    "encoder_norm": NORMS})
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
                   {"btd_solve": n, "sdf_lookup3d": n + 1,
                    "encoder_norm": NORMS})
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
            "btd_solve": n, "sdf_lookup": n + (4 if kw else 2),
            "encoder_norm": NORMS * (2 if kw else 1)})
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
                # no gradient; the encoder's forward and backward.
                drive(f"learned gradient (float64, B={b}, seed {seed}, "
                      f"{decode} decode)", run,
                      {"btd_solve": 2 * iters - 1, "sdf_lookup": iters,
                       "sdf_lookup_bwd": iters - 1,
                       "encoder_norm": 2 * NORMS})
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


@contextlib.contextmanager
def counting_norms():
    """Count the K-NORM launches of the encoders' calls on the card while
    the block runs (``ConvEncoder`` and ``ConvEncoder3D``: the learned
    planners' and the initializer network's): a launch a block for each
    forward, and as many again where a backward reaches its output.  The
    term of a tool's K-NORM count, whose encoder calls depend on its
    data."""
    from dgpmp2_tpu_torch.models.conv_encoder import ConvEncoder

    forward, rec = ConvEncoder.forward, {"launches": 0}

    def add(n):
        rec["launches"] += n

    def counted(self, x):
        out = forward(self, x)
        if out.is_cuda:
            n = len(self.features)
            add(n)
            if out.requires_grad:
                out.register_hook(lambda _, n=n: add(n))
        return out

    ConvEncoder.forward = counted
    try:
        yield rec
    finally:
        ConvEncoder.forward = forward


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
    share); the encoder's forward and backward once a step, outside the
    windows (NORMS K-NORM launches each), and its forward once a plan."""
    again = unroll if remat else 0
    plan_lookups = plan_iters + (seed_lookup + 2 if plan_iters else 0)
    return {"btd_solve": steps * (2 * unroll + again) + plan_iters,
            "sdf_lookup": steps * (1 + unroll + again) + plan_lookups,
            "sdf_lookup_bwd": steps * unroll,
            "encoder_norm": NORMS * (2 * steps + (1 if plan_iters else 0))}


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
        {**gn_per, "encoder_norm": NORMS})
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

    # One solve and one lookup a step: the eager steps and the warm-up
    # step; the capture's counts are taken back (nothing runs there), and
    # the replay's kernels are the graph's launches.
    n = CAPTURE_STEPS + 1
    drive("15 (c) capture", run, {"btd_solve": n, "sdf_lookup": n})
    per_replay = out["steps"].launches
    print(f"15 (c) one replay of the captured graph launches "
          f"{json.dumps(per_replay)} (not counted by the wrappers)")
    if per_replay != {"btd_solve": CAPTURE_STEPS,
                      "btd_solve.lane": CAPTURE_STEPS,
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
    captured_plan(smi, bench)


def captured_plan(smi, bench, calls=4):
    """15 (c): ``core.gn.plan`` of the 2-D bench (B=1024, float32, LM with
    ``track_best``, CAPTURE_STEPS iterations) ``calls`` times: the first
    runs eagerly, the second captures its CUDA graph, every one answers
    what ``gn._eager_plan`` answers, bit for bit, in every output, and the
    answer of each call survives the next.  ``gn.graph_counts`` reads 1
    eager plan (and the reference's), 1 capture and ``calls`` − 2 replays
    (its graphs dropped and counts zeroed first), and the replays ran
    ``calls`` − 1 times the eager plan's kernels (``gn.graph_launches``),
    none of which the kernel wrappers counted."""
    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.utils import profiling

    cfg = gn.OptimConfig(reg=0.1, max_iters=CAPTURE_STEPS, tol_delta=0.0,
                         method="lm")
    gn._reset_graphs()
    with torch.no_grad():
        c0 = profiling.counters()
        ref = gn._eager_plan(*bench, cfg, track_best=True)
        torch.cuda.synchronize()
        c1 = profiling.counters()
        outs = [gn.plan(*bench, cfg, track_best=True) for _ in range(calls)]
        torch.cuda.synchronize()
        c2 = profiling.counters()
    one = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    counts, ran = dict(gn.graph_counts), dict(gn.graph_launches)
    wrappers = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
    same = [all(torch.equal(getattr(o, f), getattr(ref, f))
                for f in gn.PlanResult._fields
                if getattr(ref, f) is not None) for o in outs]
    print(f"[{smi}] 15 (c) core.gn.plan B={B} LM track_best, {calls} calls: "
          f"paths {json.dumps(counts)}, replays ran {json.dumps(ran)}, "
          f"wrappers counted {json.dumps(wrappers)} (one eager plan: "
          f"{json.dumps(one)}), bit-equal to the eager loop {same}")
    if counts != {"eager": 2, "captures": 1, "replays": calls - 2,
                  "evictions": 0}:
        raise AssertionError(f"15 (c) captured plan paths {counts}")
    if ran != {k: (calls - 1) * n for k, n in one.items()} or wrappers != one:
        raise AssertionError(f"15 (c) captured plan launches {ran}, "
                             f"{wrappers} against {one}")
    if not all(same):
        raise AssertionError(f"15 (c) captured plan not bit-equal: {same}")


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


# -- phase 16: mesh execution ---------------------------------------------------

# The meshes of (b), (data, model) entries of the one card; (a) splits the
# head over (1, 2) and (1, 4).
MESH_TRAIN = ((2, 1), (2, 2))
MESH_TP = (2, 4)
MESH_STEP_REPS = 5
# (c): two processes on the card through gloo, each planning its half of
# the phase 5 bench and taking its half of a float64 step at batch 64.
PROC_WORLD, PROC_TRAIN_B, PROC_TIMEOUT_S = 2, 64, 120
# The campaign's eps_bounded losses (eps_bounded_learn), a small imitation
# term added so that final_pos_mse moves too.
MESH_WEIGHTS = dict(ext_loss_weight=1.0, ext_obs_lambda=5.0,
                    pos_loss_weight=0.1, vel_loss_lambda=0.1)
MESH_COV = dict(qc_inv=np.eye(2), cost_sigma=0.01, epsilon_dist=0.4,
                k_s=0.01, k_g=0.01)


def mesh_of(dev, data, mp):
    """A (data, model) mesh of ``data * mp`` entries of ``dev``."""
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    return make_mesh([dev] * (data * mp), model_parallel=mp)


def rel_max(a, b):
    """The largest |a - b| over the largest |b|."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def tp_head(dev, smi, b=TRAIN_B):
    """16 (a): the campaign's head (Linear 2250→1000→640→302, random
    weights about the static init) on the card, replicated and
    tensor-parallel over (1, 2) and (1, 4) meshes of entries of it: the
    forward and every parameter's gradient (reduced and joined) against the
    replicated head's, within 1e-12 relative in float64; the largest gap
    in float32 stated."""
    import copy

    from dgpmp2_tpu_torch.models.cov_head import TensorParallelHead
    from dgpmp2_tpu_torch.parallel import sharding as sh

    _, variables, _, th0, _, _ = learned_setup(
        dev, *bench_inputs(2), dtype=torch.float64, weights_seed=16)
    rng = np.random.default_rng(16)
    head64 = variables["head"]
    n_in = head64.dense[0].in_features
    pos_len = 2 * th0.shape[1]
    x = [torch.tensor(rng.standard_normal((b, n)), device=dev)
         for n in (n_in - pos_len, pos_len)]
    cot = torch.tensor(rng.standard_normal((b, head64.out.out_features)),
                       device=dev)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, None)):
        head = copy.deepcopy(head64).to(dtype)
        feats, pos, c = (t.to(dtype) for t in (*x, cot))
        want = head(feats, pos)
        (want * c).sum().backward()
        grads = {n: p.grad for n, p in head.named_parameters()}
        for mp in MESH_TP:
            sp = sh.shard_params(torch.nn.ModuleDict({"head": head}),
                                 mesh_of(dev, 1, mp))
            tp = TensorParallelHead([s["head"] for s in sp.group(0)])
            got = tp(feats, pos)
            (got * c).sum().backward()
            sh.reduce_grads(sp)
            joined = sh.join_params(sp)["head"]
            errs = {"forward": rel_max(got, want)}
            errs.update({n: rel_max(p.grad, grads[n])
                         for n, p in joined.named_parameters()})
            worst = max(errs, key=errs.get)
            print(f"[{smi}] 16 (a) tensor-parallel head (B={b}, "
                  f"{n_in}->1000->640->{head.out.out_features}) on a (1, "
                  f"{mp}) mesh of the card, {str(dtype)[6:]}: forward and "
                  f"{len(errs) - 1} gradients against the replicated head, "
                  f"max rel err {errs[worst]:.3e} at {worst}"
                  + (f" (tol {tol:g})" if tol else " (stated)"))
            if tol is not None and not errs[worst] <= tol:
                raise AssertionError(f"16 (a) mp={mp}: {errs[worst]}")


def replicas_equal(state) -> bool:
    """Every device holding a part of a parameter holds the same bits of
    it and of its optimizer state."""
    from dgpmp2_tpu_torch.parallel import sharding as sh

    sp, opt = state.variables, state.opt_state
    for name in sp.specs:
        keys = [name] + [k for k in opt.specs if k.startswith(name + ".")]
        for group in sh.holders(sp, name):
            for k in group[1:]:
                if not torch.equal(sp.named(k)[name],
                                   sp.named(group[0])[name]):
                    return False
                if not all(torch.equal(opt.named(k)[key],
                                       opt.named(group[0])[key])
                           for key in keys[1:]):
                    return False
    return True


def mesh_train_batch(dev, b, dtype, seed, t=T):
    """The eps_bounded planner (random weights about the static init from
    ``seed``) and a batch of ``b`` bench problems whose expert paths are
    the seeds plus noise: (planner, variables, batch)."""
    imgs, start, goal = bench_inputs(b, seed=seed)
    planner, variables, _, th0, sdf, im = learned_setup(
        dev, imgs, start, goal, lkw=EPS_BOUNDED, t=t, dtype=dtype,
        weights_seed=seed)
    noise = np.random.default_rng(seed).standard_normal(tuple(th0.shape))
    batch = {"im": im, "sdf": sdf, "start": torch.tensor(start, device=dev),
             "goal": torch.tensor(goal, device=dev),
             "th_opt": th0 + 0.1 * torch.tensor(noise, dtype=dtype,
                                                device=dev),
             "cov_scalars": MESH_COV}
    return planner, variables, batch


# The optimizer of the float64 comparisons: SGD, whose update is the
# clipped gradient (as in train_step_card_vs_cpu).  Adam's first step,
# g / (|g| + 1e-8) per element, turns a gradient's last-bit rounding where
# |g| ~ 1e-8 into ~1e-12 of its learning rate; it runs the float32 timing.
MESH_SGD = ("sgd", {"alpha": 0.01})
MESH_ADAM = ("adam", {"alpha": 3e-4})


def train_steps(planner, variables, batch, unroll, tk, mesh=None,
                opt=MESH_SGD):
    """A fresh optimizer state (``opt``: name and settings) over a copy of
    ``variables``, sharded over ``mesh`` when given, and its training step
    (unroll in windows of ``tk``, remat, clipping at 2)."""
    import copy

    from dgpmp2_tpu_torch.learn.losses import LossWeights
    from dgpmp2_tpu_torch.learn.train import (TrainConfig, TrainState,
                                              make_optimizer,
                                              make_train_step)
    from dgpmp2_tpu_torch.parallel import sharding as sh

    v = copy.deepcopy(variables)
    state = TrainState(0, v, make_optimizer(*opt)(v.parameters()))
    if mesh is not None:
        state = sh.shard_state(state, mesh)
    step = make_train_step(planner, LossWeights(**MESH_WEIGHTS),
                           TrainConfig(T=unroll, tk=tk), mesh=mesh)
    return state, step


def joined_weights(state) -> dict:
    """The weights after a step and the gradients that stepped them, by
    name (``<name>.grad``), a sharded state's joined."""
    from dgpmp2_tpu_torch.parallel import sharding as sh

    v = state.variables
    v = sh.join_params(v) if isinstance(v, sh.ShardedParams) else v
    out = {n: p.detach() for n, p in v.named_parameters()}
    out.update({f"{n}.grad": p.grad for n, p in v.named_parameters()})
    return out


def step_errors(metrics, weights, want_metrics, want_weights) -> dict:
    """Relative gaps of a step's metrics, updated weights and gradients
    (each to its largest entry) from a reference step's."""
    errs = {k: abs(float(metrics[k]) / float(want_metrics[k]) - 1)
            for k in want_metrics}
    errs.update({n: rel_max(w, want_weights[n]) for n, w in weights.items()})
    return errs


def step_verdict(errs, tol):
    """(the worst metric or weight, the worst gradient, whether the metrics
    and updated weights are within ``tol`` and the gradients within 10 ×
    ``tol``): a gradient whose terms cancel over B·H·W (a convolution's
    bias or a LayerNorm's scale before a LayerNorm) keeps the rounding of a
    sum over the shard's rows in another order, which phase 16 (c) states
    (train_step_card_vs_cpu holds gradients at 1e-9 for the same
    reason)."""
    grads = {k: v for k, v in errs.items() if k.endswith(".grad")}
    rest = {k: v for k, v in errs.items() if k not in grads}
    w, g = max(rest, key=rest.get), max(grads, key=grads.get)
    return ((w, rest[w]), (g, grads[g]),
            rest[w] <= tol and grads[g] <= 10 * tol)


def sharded_training(dev, smi):
    """16 (b): one eps_bounded training step (B=TRAIN_B, 128², T=100,
    unroll 10 in windows of 5, remat, clipping) unsharded and on the (2, 1)
    and (2, 2) meshes of entries of the card.  In float64 (the head decoded
    in float64, SGD): loss, grad_norm, final_err, final_pos_mse and every
    updated weight joined back within 1e-10 of the unsharded step, the
    gradients within 1e-9 (:func:`step_verdict`), the replicas bit-equal,
    launches the unsharded step's times the data shards.  In float32 (Adam,
    as the campaign): ms per step, median of MESH_STEP_REPS, one step
    profiled, the replicas bit-equal after."""
    one = train_step_counts(1)
    ref = None
    for dtype in (torch.float64, torch.float32):
        planner, variables, batch = mesh_train_batch(dev, TRAIN_B, dtype, 16)
        if dtype == torch.float64:
            decode_in_float64(planner)
        for shape in (None, *MESH_TRAIN):
            mesh = None if shape is None else mesh_of(dev, *shape)
            shards = 1 if shape is None else shape[0]
            label = "unsharded" if shape is None else f"{shape} mesh"
            if dtype == torch.float32:
                state, step = train_steps(planner, variables, batch,
                                          TRAIN_UNROLL, TRAIN_TK, mesh,
                                          MESH_ADAM)
                ms = cuda_ms(lambda: step(state, batch, 0),
                             reps=MESH_STEP_REPS, warmup=1)
                _, prof = profile_run(lambda: step(state, batch, 0))
                same = "" if mesh is None else (
                    f"; replicas bit-equal after {MESH_STEP_REPS + 3} Adam "
                    f"steps: {replicas_equal(state)}")
                print(f"[{smi}] 16 (b) training step, {label} (float32, "
                      f"Adam, B={TRAIN_B}, {shards} data shard(s) one after "
                      f"another on the card): {ms:.3f} ms per step (CUDA "
                      f"events, median of n={MESH_STEP_REPS}); one "
                      f"profiled step: wall {prof['wall_ms']:.3f} ms, device "
                      f"busy {prof['busy_ms']:.3f} ms, {prof['ops']} device "
                      f"launches{same}")
                if mesh is not None and not replicas_equal(state):
                    raise AssertionError(f"16 (b) {shape}: replicas differ")
                continue
            state, step = train_steps(planner, variables, batch, TRAIN_UNROLL,
                                      TRAIN_TK, mesh)
            (state, metrics), _ = drive(
                f"16 (b) training step, {label} (float64, B={TRAIN_B})",
                lambda: step(state, batch, 0),
                {k: v * shards for k, v in one.items()})
            if shape is None:
                ref = metrics, joined_weights(state)
                continue
            errs = step_errors(metrics, joined_weights(state), *ref)
            (w, ew), (g, eg), ok = step_verdict(errs, 1e-10)
            same = replicas_equal(state)
            print(f"[{smi}] 16 (b) training step on a {shape} mesh of the "
                  f"card against the unsharded step, float64, SGD: 4 "
                  f"metrics and {(len(errs) - 4) // 2} updated weight "
                  f"tensors max rel err {ew:.3e} at {w} (tol 1e-10), their "
                  f"gradients {eg:.3e} at {g} (tol 1e-9); grad_norm "
                  f"{float(metrics['grad_norm']):.6g}; replicas bit-equal: "
                  f"{same}")
            if not (ok and same):
                raise AssertionError(f"16 (b) {shape}: {errs}, {same}")


def mesh_process(rank, world, port, dev, b=B, t=T, iters=50,
                 train_b=PROC_TRAIN_B, unroll=TRAIN_UNROLL, tk=TRAIN_TK,
                 tol64=1e-10, timeout_s=PROC_TIMEOUT_S):
    """16 (c) in process ``rank`` of ``world``, joined through gloo at
    tcp://localhost:``port`` on ``dev`` (``make_multihost_mesh``: dcn =
    world): ``core.gn.plan`` of this process's rows of the phase 5 bench
    (``b`` problems, ``iters`` iterations) gathered over the processes,
    against the whole batch planned here, float32 (the gap stated) and
    float64 (within ``tol64``); then one float64 data-parallel training
    step over the processes (``train_b`` problems, the head split over two
    entries of ``dev`` in each) against the one-process step within
    ``tol64`` (its gradients within 10 × ``tol64``: :func:`step_verdict`),
    the weights bit-equal on every process.  A collective that
    waits ``timeout_s`` raises.  Prints one line ``mesh_process {json}``
    with its launches."""
    import datetime

    import torch.distributed as dist

    from dgpmp2_tpu_torch.core import gn
    from dgpmp2_tpu_torch.parallel import sharding as sh

    mods = counters()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = sh.make_multihost_mesh(devices=[dev])
        cfg = gn.OptimConfig(reg=0.1, max_iters=iters, tol_delta=0.0)
        imgs, start, goal = bench_inputs(b)
        rec = {"rank": rank, "mesh": mesh.shape, "launches": {},
               "btd_regimes": {}}
        for dtype in (torch.float32, torch.float64):
            spec, robot, params, th0, sdf = port_problem(imgs, start, goal,
                                                         dev, dtype, t)
            want = gn.plan(spec, robot, params, th0, sdf, cfg).th

            def run():
                shards = sh.shard_batch((params, th0, sdf), mesh)
                return sh.gather_batch([gn.plan(spec, robot, *s, cfg).th
                                        for s in shards], mesh=mesh)

            got, counts, regimes = counted(run, mods, dev)
            rec[f"plan_{str(dtype)[6:]}_max_abs_gap"] = float(
                (got - want).abs().max())
            rec["launches"][f"plan_{str(dtype)[6:]}"] = counts
            rec["btd_regimes"][f"plan_{str(dtype)[6:]}"] = regimes
            if dtype == torch.float64 and not rel_max(got, want) <= tol64:
                raise AssertionError(f"process {rank}: float64 plan "
                                     f"{rel_max(got, want)}")
        planner, variables, batch = mesh_train_batch(dev, train_b,
                                                     torch.float64, 5, t)
        decode_in_float64(planner)
        state, step = train_steps(planner, variables, batch, unroll, tk)
        state, want_m = step(state, batch, 0)
        want_w = joined_weights(state)
        mesh2 = sh.make_multihost_mesh(2, devices=[dev, dev])
        state, step = train_steps(planner, variables, batch, unroll, tk,
                                  mesh2)
        (state, metrics), counts, regimes = counted(
            lambda: step(state, batch, 0), mods, dev)
        rec["launches"]["train_step"] = counts
        rec["btd_regimes"]["train_step"] = regimes
        (w, ew), (g, eg), ok = step_verdict(
            step_errors(metrics, joined_weights(state), want_m, want_w),
            tol64)
        flat = torch.cat([w.reshape(-1) for w in
                          joined_weights(state).values()])
        every = sh.process_all_gather(flat[None], mesh2)
        rec.update(train_max_rel_err=ew, train_worst=w,
                   train_grad_max_rel_err=eg, train_grad_worst=g,
                   weights_equal_on_every_process=bool(
                       (every == every[0]).all()),
                   replicas_equal=replicas_equal(state),
                   train_mesh=mesh2.shape)
        if not (ok and rec["replicas_equal"]
                and rec["weights_equal_on_every_process"]):
            raise AssertionError(f"process {rank}: training step {rec}")
        print("mesh_process " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def process_split(dev, smi):
    """16 (c): :func:`mesh_process` in PROC_WORLD child processes of this
    script on the card (the kernels built here first: two builds into
    ``dgpmp2_tpu_torch/build/`` at once could clobber each other), each
    with a timeout; a child that fails or times out fails the phase.  Their
    launches join the kernels line: per process, the plan's iterations
    (K-BTD) and iterations + 1 (K-LOOKUP) for each dtype, and one
    training step of its rows."""
    import socket

    from dgpmp2_tpu_torch.ops.cuda import _build

    _build.library()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [ROOT / "build" / f"mesh_process_{r}.log"
            for r in range(PROC_WORLD)]
    logs[0].parent.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mesh-process", str(r), str(PROC_WORLD), str(port)],
                    stdout=fp, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.monotonic() + PROC_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        line = [x for x in text.splitlines()
                if x.startswith("mesh_process ")]
        if p.returncode != 0 or len(line) != 1:
            raise AssertionError(f"16 (c) process {r} exited "
                                 f"{p.returncode}:\n{text[-4000:]}")
        recs.append(json.loads(line[0][len("mesh_process "):]))
    per_plan = {"btd_solve": 50, "sdf_lookup": 51}
    per_step = train_step_counts(1)
    for rec in recs:
        want = {"plan_float32": per_plan, "plan_float64": per_plan,
                "train_step": per_step}
        for run, counts in rec["launches"].items():
            expect = {k: want[run].get(k, 0) for k in counts}
            print(f"16 (c) process {rec['rank']}, {run} launches "
                  f"{json.dumps(counts)}, expected {json.dumps(expect)}")
            if counts != expect:
                raise AssertionError(f"16 (c) {run}: {counts}")
            add_totals(counts, rec["btd_regimes"][run])
        print(f"[{smi}] 16 (c) process {rec['rank']} of {PROC_WORLD} (mesh "
              f"{rec['mesh']}, gloo on the one card): its {B // PROC_WORLD} "
              f"rows of the B={B} bench gathered against the one-process "
              f"plan, max |gap| float32 {rec['plan_float32_max_abs_gap']:.3e}"
              f", float64 {rec['plan_float64_max_abs_gap']:.3e}; a float64 "
              f"training step (B={PROC_TRAIN_B}, mesh {rec['train_mesh']}) "
              f"against the one-process step: metrics and updated weights "
              f"max rel err {rec['train_max_rel_err']:.3e} at "
              f"{rec['train_worst']} (tol 1e-10), gradients "
              f"{rec['train_grad_max_rel_err']:.3e} at "
              f"{rec['train_grad_worst']} (tol 1e-9), weights equal on "
              f"every process "
              f"{rec['weights_equal_on_every_process']}, replicas "
              f"{rec['replicas_equal']}")


def mesh_execution(dev, smi):
    """Phase 16: (a) the tensor-parallel head, (b) the sharded training
    step, (c) planning and a training step across processes."""
    phase("16 mesh execution: (a) the tensor-parallel head")
    tp_head(dev, smi)
    phase("16 (b) the sharded training step")
    sharded_training(dev, smi)
    phase("16 (c) planning and a training step across processes")
    process_split(dev, smi)


# Phase 17: the examples and the workflow scripts.  An example's launches
# by kernel, from its result ``out``, its module ``m`` and the record of its
# core.gn.plan calls ``rec`` (counting_plans): each gn.plan makes a K-BTD
# solve per iteration and a lookup at its seed and at each proposal
# (plan_counts with after=0); GPMP2Planner.plan_batch a solve and two
# lookups per host iteration (the step's residuals and the proposal's
# error) and one at the seed; a DiffGPMP2Planner.step a solve and two
# lookups; a multistart scoring, Env3D query, graph_error or the examples'
# own clearance checks one lookup each; a gradient through a plan an
# adjoint solve per iteration and a K-LOOKUP-BWD per lookup upstream of the
# loss (not the last proposal's, which only feeds the error trace); a
# generated world's plan one re-validation lookup (generate_split).


def _batch_iters(*runs):
    """Host iterations of GPMP2Planner.plan_batch runs: each runs until
    its slowest problem stops."""
    return [int(np.max(np.asarray(r["iters"]))) for r in runs]


def _generated(rec, extra_plans=1):
    """Lookups of generate_split plans (each re-validated once) and of
    ``extra_plans`` more plans that are not."""
    return rec["iters"] + 2 * rec["plans"] - extra_plans


def _learned_counts(m, rec):
    """learned_vs_static: its expert data (generate_split) and static plan
    (counted), ``m.STEPS`` training steps of one window of 5 (remat), and
    two learned plans with track_best and three graph errors."""
    train = train_step_counts(m.STEPS, unroll=5)
    return {"btd_solve": rec["iters"] + train["btd_solve"] + 2 * m.ITERS,
            "sdf_lookup": (_generated(rec) + train["sdf_lookup"]
                           + 2 * (m.ITERS + 1) + 3),
            "sdf_lookup_bwd": train["sdf_lookup_bwd"],
            "encoder_norm": train["encoder_norm"] + 2 * NORMS}


EXAMPLE_LAUNCHES = {
    "gpmp2_2d_example": lambda out, m, rec: {
        "btd_solve": sum(out[k]["iters"] for k in ("gauss_newton", "lm")),
        "sdf_lookup": sum(2 * out[k]["iters"] + 1
                          for k in ("gauss_newton", "lm"))},
    "gpmp2_2d_step_example": lambda out, m, rec: {
        "btd_solve": out["steps"], "sdf_lookup": 4 * out["steps"] + 1},
    "diff_gpmp2_2d_example": lambda out, m, rec: {
        "btd_solve": rec["iters"] * 3 // 2,
        "sdf_lookup": rec["iters"] + rec["plans"],
        "sdf_lookup_bwd": rec["iters"] // 2},
    "diff_gpmp2_2d_step_example": lambda out, m, rec: {
        "btd_solve": out["steps"], "sdf_lookup": 2 * out["steps"]},
    "diff_gpmp2_2d_batch_example": lambda out, m, rec: plan_counts(rec, after=0),
    "diff_gpmp2_2d_batch_step_example": lambda out, m, rec: {
        "btd_solve": out["steps"], "sdf_lookup": 2 * out["steps"]},
    "diff_gpmp2_2d_vel_limits_example": lambda out, m, rec: plan_counts(
        rec, after=0),
    "diff_gpmp2_gp_inter_example": lambda out, m, rec: plan_counts(
        rec, after=1),  # one fine clearance check a plan
    "diff_gpmp2_nonholonomic_example": lambda out, m, rec: plan_counts(
        rec, after=0),
    "planar_arm_example": lambda out, m, rec: plan_counts(rec, after=0),
    "self_collision_example": lambda out, m, rec: plan_counts(rec, after=0),
    "arm_taskspace_example": lambda out, m, rec: plan_counts(
        rec, after=1),  # the obstacle clearance of the plan
    "rrt_star_example": lambda out, m, rec: plan_counts(rec, after=0),
    # The seed's error, then per run a scoring (two when staged) and the
    # selected plans' error.
    "multistart_example": lambda out, m, rec: {
        "btd_solve": rec["iters"],
        "sdf_lookup": rec["iters"] + rec["plans"] + 1 + 2 * len(m.RUNS) + 1},
    # Per world: a scoring, an Env3D query and two errors.
    "plan3d_example": lambda out, m, rec: plan_counts(
        rec, lookup="sdf_lookup3d", after=4),
    "replanning_example": lambda out, m, rec: {
        "btd_solve": sum(_batch_iters(out["initial"], out["cold"],
                                      out["warm"])),
        "sdf_lookup": sum(2 * j + 1 for j in _batch_iters(
            out["initial"], out["cold"], out["warm"]))},
    # The warm-up dispatch and the clients' two.
    "serving_example": lambda out, m, rec: plan_counts(rec, after=0),
    "dataset_loading_example": lambda out, m, rec: {
        "btd_solve": rec["iters"], "sdf_lookup": _generated(rec)},
    # The task loss's plan: an adjoint solve per iteration, a K-LOOKUP-BWD
    # per proposal but the last (the seed's points carry no gradient).
    "diff_gpmp2_multi_dataset_example": lambda out, m, rec: {
        "btd_solve": rec["iters"] + m.CFG.max_iters,
        "sdf_lookup": _generated(rec),
        "sdf_lookup_bwd": m.CFG.max_iters - 1},
    "learned_vs_static_example": lambda out, m, rec: _learned_counts(m, rec),
    "report_stats_example": lambda out, m, rec: {},
}


# Flags of an example's phase-17 run beyond ``--device``: plain GN on the
# task-space arm is chaotic and has missed its tip in float32 on the H100,
# so the card runs that example under LM, as phase 8 plans the arm, and
# records plain GN beside it (taskspace_gn_record).
EXAMPLE_ARGV = {"arm_taskspace_example": ["--method", "lm"]}


def summary(out, path="") -> dict:
    """The numbers of an example's result: scalars, and arrays of at most
    16 entries, rounded; trajectories and gradients left out."""
    found = {}
    if isinstance(out, dict):
        for k, v in out.items():
            found.update(summary(v, f"{path}/{k}" if path else k))
        return found
    if isinstance(out, (bool, int, float, np.generic)):
        found[path] = round(float(out), 6)
    elif isinstance(out, (torch.Tensor, np.ndarray)):
        a = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)
        if a.dtype.kind in "biuf" and a.size <= 16:
            found[path] = np.round(a.astype(np.float64), 6).tolist()
    return found


def run_example(name, dev, smi):
    """One example's ``main()`` on ``dev`` through :func:`drive`, its plans
    counted; its claims and invariants hold or it raises.  Returns its
    wall seconds."""
    import importlib

    from dgpmp2_tpu_torch.examples import _common

    m = importlib.import_module(f"dgpmp2_tpu_torch.examples.{name}")
    argv = ([] if dev.type == "cuda" else ["--device", str(dev)]) + \
        EXAMPLE_ARGV.get(name, [])
    with counting_plans() as rec:
        t0 = time.perf_counter()
        out, counts = drive(f"example {name}", lambda: m.main(argv),
                            lambda out: EXAMPLE_LAUNCHES[name](out, m, rec))
        wall = time.perf_counter() - t0
    for path, x in _leaves(out):
        a = _common.np_(x) if isinstance(x, (torch.Tensor, np.ndarray)) \
            else None
        if a is not None and a.dtype.kind == "f" and not np.isfinite(a).all():
            raise AssertionError(f"example {name}: {path} not finite")
    bad = _common.unimproved(out, getattr(m, "BASELINE", None))
    if bad:
        raise AssertionError(f"example {name}: errors not lowered: {bad}")
    print(f"[{smi}] example {' '.join([name, *argv])}: {wall:.3f} s wall; "
          f"{json.dumps(summary(out))}; launches "
          f"{json.dumps({k: counts[k] for k in KERNELS})}", flush=True)
    return wall


def taskspace_gn_record(dev, smi):
    """The task-space example planned as the JAX example plans it, by
    plain GN in float32: its measures printed, its claims (tip within
    0.1 m, clear of the obstacle) reported, not held."""
    from dgpmp2_tpu_torch.examples import arm_taskspace_example as m

    with counting_plans() as rec:
        out, _ = drive("example arm_taskspace_example, plain GN",
                       lambda: m.solve(dev, torch.float32),
                       lambda out: plan_counts(rec, after=1))
    held = out["tip_err"] < 0.1 and out["clearance"] > 0.0
    print(f"[{smi}] example arm_taskspace_example under plain GN (the JAX "
          f"example's method), float32: tip error {out['tip_err']:.4f} m, "
          f"clearance {out['clearance']:+.4f} m, self gap "
          f"{out['self_gap']:+.4f} m, max |q| {out['max_q']:.3f}: claims "
          f"{'held' if held else 'missed'}", flush=True)


def script_chain(root, device=None, train=8, test=4, imsize=IMSIZE, t=T,
                 gen_iters=60, epochs=2, batch=8):
    """``dgpmp2_tpu_torch/scripts/*.sh`` in a chain through ``bash``, each
    in a subprocess (on the card unless ``device`` is given), at a reduced
    size: ``train`` + ``test`` forest worlds at ``imsize``² (2 problems a
    world, T=``t``, the generator's LM of ``gen_iters`` iterations),
    ``epochs`` of the initializer and of the planner (learn_params.yaml
    with ``epochs`` and ``batch``, a quarter of the problems held out), the
    validation of the last checkpoint, then ``report_stats_example`` on its
    results.  A ``t`` other than the YAMLs' 100 goes to the scripts as a
    plan YAML of that T.  Returns (seconds by script, the report)."""
    import shutil

    import yaml

    from dgpmp2_tpu_torch.examples import report_stats_example
    from dgpmp2_tpu_torch.utils.config import CONFIG_DIR

    root = Path(root)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    learn = yaml.safe_load((CONFIG_DIR / "learn_params.yaml").read_text())
    learn["optim"].update(epochs=epochs, batch_size=batch)
    learn["data"]["valid_size"] = 0.25
    (root / "learn.yaml").write_text(yaml.safe_dump(learn))
    yamls = ["--learn_param_file", str(root / "learn.yaml")]
    if t != T:
        plan = yaml.safe_load((CONFIG_DIR / "gpmp2_2d_params.yaml")
                              .read_text())
        plan["gpmp2"]["planner_params"]["total_time_step"] = t
        (root / "plan.yaml").write_text(yaml.safe_dump(plan))
        yamls += ["--plan_param_file", str(root / "plan.yaml")]
    valid = int(0.25 * 2 * train)
    dev = [] if device is None else ["--device", str(device)]
    data, init, model = (str(root / n) for n in ("data", "init", "exp"))
    steps = (
        ("generate_dataset.sh", [data, *dev, "--num_train", str(train),
                                 "--num_test", str(test), "--im_size",
                                 str(imsize), "--total_time_step", str(t),
                                 "--max_iters", str(gen_iters)]),
        ("train_init_network.sh", [data, init, *dev, "--epochs", str(epochs),
                                   "--batch_size", str(batch),
                                   "--total_time_step", str(t)]),
        ("train_planner.sh", [data, model, *dev, *yamls]),
        ("valid_planner.sh", [data, model, *dev, *yamls, "--batch_size",
                              str(valid)]),
    )
    env = dict(os.environ, PYTHON=sys.executable)
    seconds = {}
    for script, args in steps:
        log = root / f"{script}.log"
        t0 = time.perf_counter()
        with open(log, "w") as fp:
            done = subprocess.run(
                ["bash", str(ROOT / "dgpmp2_tpu_torch" / "scripts" / script),
                 *args], cwd=root, env=env, stdout=fp,
                stderr=subprocess.STDOUT, timeout=600)
        seconds[script] = time.perf_counter() - t0
        if done.returncode != 0:
            print(log.read_text()[-4000:])
            raise AssertionError(f"{script} exited {done.returncode}")
    report = report_stats_example.main(
        ["--results_glob", str(Path(model) / "results*.yaml")])
    if not report["rows"] or not 0.0 <= report["rows"][0][1][
            "solve_rate"] <= 1.0:
        raise AssertionError(f"no results to report: {report}")
    return seconds, report


def examples(dev, smi):
    """Phase 17: every example on the card, then the scripts' chain."""
    from dgpmp2_tpu_torch.examples import EXAMPLES

    phase("17 examples and scripts")
    t0 = time.perf_counter()
    walls = {}
    for name in EXAMPLES:
        if name == "arm_taskspace_example":
            taskspace_gn_record(dev, smi)
        walls[name] = run_example(name, dev, smi)
    seconds, report = script_chain(
        ROOT / "build" / "examples_chain",
        None if dev.type == "cuda" else dev)
    row = report["rows"][0][1]
    print(f"[{smi}] scripts, 8 + 4 worlds at {IMSIZE}^2, T={T}, 2 epochs "
          f"(the scripts' defaults: 100 + 20 worlds, 20 epochs): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + f"; solve_rate {row['solve_rate']:.4f}, avg_gp_error "
          f"{row['avg_gp_error']:.4f}", flush=True)
    print(f"[{smi}] phase 17: {time.perf_counter() - t0:.2f} s "
          f"({sum(walls.values()):.2f} s in the examples)", flush=True)


# -- phase 18: the campaign and sweep tools --------------------------------

CAMPAIGN_FAMILIES = ["multi_obs", "forest"]


def tool_runs(tmp: Path) -> list:
    """Phase 18's tool runs in order: (name, the tool's argv) under the
    directory ``tmp``; widths are the tools' own, depth is cut (the cuts in
    :func:`campaigns`' docstring)."""
    a, ms, arm = tmp / "a", tmp / "ms", tmp / "arm"
    model = f"eps_bounded:{a / 'eps_bounded_vars.npz'}"
    ms_flags = ["--families", *CAMPAIGN_FAMILIES, "--restarts", "32",
                "--amp", "2.0", "--batch", "32", "--prune_iters", "10",
                "--keep", "8", "--sigmas", "0.01", "0.02", "0.05"]
    return [
        ("learned_campaign", [
            "--out", str(a), "--families", *CAMPAIGN_FAMILIES,
            "--num_train", "40", "--num_test", "16", "--probs", "4", "--t",
            str(T), "--epochs", "2", "--batch", "128", "--eval_every", "1",
            "--configs", "eps_bounded"]),
        ("multistart_sweep", ["--data_root", str(a), "--out", str(ms),
                              *ms_flags]),
        ("multistart_sweep learned", [
            "--data_root", str(a), "--out", str(ms), *ms_flags,
            "--no_static", "--cov_model", model]),
        ("multistart_sweep rrt", [
            "--data_root", str(a), "--out", str(tmp / "ms_rrt"),
            *ms_flags, "--families", "forest", "--rrt_seeds", "2",
            "--rrt_plan_time", "0.2"]),
        ("init_experiment", [
            "--data", str(a / "data_forest"), "--out", str(tmp / "init"),
            "--epochs", "2", "--eval_every", "1", "--restarts", "16",
            "--batch", "32", "--cov_model", model]),
        ("arm_campaign", [
            "--out", str(arm), "--num_train", "256", "--num_test", "128",
            "--epochs", "2", "--batch", "128", "--eval_every", "1",
            "--configs", "eps_bounded_lr1"]),
        ("arm_multistart_eval", ["--out", str(arm), "--restarts", "16",
                                 "--cov_model", "eps_bounded_lr1"]),
        ("plan3d_sweep", ["--out", str(tmp / "plan3d")]),
        ("learn3d_campaign", [
            "--out", str(tmp / "learn3d"), "--family", "boxes3d",
            "--num_train", "16", "--num_test", "16", "--epochs", "2"]),
        ("headline_campaign", ["--out", str(tmp / "headline"), "--scale",
                               "smoke"]),
    ]


TOOLS_3D = ("plan3d_sweep", "learn3d_campaign")
TOOLS_TRAINING = ("learned_campaign", "arm_campaign", "learn3d_campaign",
                  "headline_campaign")
# Where a tool's YAMLs have a committed twin written by the JAX tool under
# runs/: (file under --out, file under runs/, depth from which the keys are
# compared; the shallower keys name families or configs of that run).
REFERENCE_KEYS = {
    "learned_campaign": (
        ("results.yaml", "headline/results.yaml", 0),
        ("results_by_family.yaml", "headline/results_by_family.yaml", 1),
        ("static_sensitivity.yaml", "headline/static_sensitivity.yaml", 0),
        ("static_sensitivity_forest.yaml",
         "headline/static_sensitivity_forest.yaml", 0),
        ("static_val.yaml", "headline/static_val.yaml", 0),
        ("eps_bounded_gate.yaml", "headline/eps_bounded_gate.yaml", 0)),
    "multistart_sweep learned": (
        ("results.yaml", "headline/multistart/results.yaml", 1),),
    "init_experiment": (("results.yaml", "init_forest/results.yaml", 0),),
    "arm_campaign": (
        ("results.yaml", "arm_campaign/results.yaml", 1),
        ("static_sensitivity.yaml", "arm_campaign/static_sensitivity.yaml",
         0)),
    "plan3d_sweep": (("results.yaml", "plan3d/results.yaml", 0),),
    "learn3d_campaign": (("results.yaml", "learn3d_window/results.yaml", 0),),
    "headline_campaign": (
        ("results.yaml", "headline/results.yaml", 0),
        ("results_by_family.yaml", "headline/results_by_family.yaml", 1)),
}
# Files each tool must have written (beside those above).
TOOL_FILES = {
    "learned_campaign": ("table.md", "per_family.md", "eps_bounded_vars.npz",
                         "eps_bounded_train_loss.yaml"),
    "multistart_sweep": ("results.yaml", "table.md"),
    "multistart_sweep rrt": ("results.yaml", "table.md"),
    "init_experiment": ("table.md", "initnet_vars.npz"),
    "arm_campaign": ("table.md", "data_train.npz", "data_test.npz",
                     "eps_bounded_lr1_vars.npz",
                     "eps_bounded_lr1_train_loss.yaml"),
    "arm_multistart_eval": ("multistart_results.yaml",),
    "plan3d_sweep": ("table.md",),
    "learn3d_campaign": ("table.md",),
    "headline_campaign": ("headline.md", "multistart/results.yaml",
                          "eps_bounded_vars.npz"),
}


def yaml_keys(tree, skip=0, depth=0) -> set:
    """(depth, key) of every dict key of a YAML tree at ``skip`` or deeper,
    a float key (a sigma) as "*"."""
    found = set()
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else ())
    for k, v in items:
        if isinstance(tree, dict) and depth >= skip:
            found.add((depth, "*" if isinstance(k, float) else str(k)))
        found |= yaml_keys(v, skip, depth + 1)
    return found


def check_yaml_tree(name, tree, path=""):
    """Every number of a tool's YAML finite, and every rate (a key holding
    "rate" or "solve") in [0, 1]."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_yaml_tree(name, v, f"{path}/{k}")
        return
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            check_yaml_tree(name, v, f"{path}/{i}")
        return
    if isinstance(tree, bool) or not isinstance(tree, (int, float)):
        return
    if not np.isfinite(tree):
        raise AssertionError(f"{name}: {path} = {tree} not finite")
    leaf = path.rsplit("/", 1)[-1]
    if ("rate" in leaf or "solve" in leaf) and not 0.0 <= tree <= 1.0:
        raise AssertionError(f"{name}: rate {path} = {tree} outside [0, 1]")


def check_tool_files(name, out):
    """The files a tool run must have written, its YAMLs' numbers, and their
    keys against the JAX tool's committed twins; returns the YAML files."""
    import yaml

    for f in TOOL_FILES.get(name, ()):
        if not (out / f).exists():
            raise AssertionError(f"{name}: {f} not written")
    written = sorted(out.rglob("*.yaml"))
    for path in written:
        check_yaml_tree(f"{name} {path.name}",
                        yaml.safe_load(path.read_text()))
    for f, ref, skip in REFERENCE_KEYS.get(name, ()):
        got = yaml_keys(yaml.safe_load((out / f).read_text()), skip)
        want = yaml_keys(yaml.safe_load(
            (ROOT / "runs" / ref).read_text()), skip)
        if got != want:
            raise AssertionError(
                f"{name} {f}: keys {sorted(got ^ want)} differ from "
                f"runs/{ref}")
    return [str(p.relative_to(out)) for p in written]


@contextlib.contextmanager
def capturing(module, fn_name):
    """Record the return value of each call of ``module.fn_name`` while the
    block runs."""
    fn, calls = getattr(module, fn_name), []

    def recorded(*args, **kw):
        calls.append(fn(*args, **kw))
        return calls[-1]

    setattr(module, fn_name, recorded)
    try:
        yield calls
    finally:
        setattr(module, fn_name, fn)


def check_reload(name, planner, state, out_dir, dev):
    """The run's flat checkpoint reloaded through ``load_flat_variables``
    into fresh weights plans its first test batch bit-equal to the model in
    memory (50 iterations, ``track_best``)."""
    from dgpmp2_tpu_torch.learn import checkpoints
    from dgpmp2_tpu_torch.tools import arm_campaign, learned_campaign
    from dgpmp2_tpu_torch.tools._common import fixed_params, straight

    if name == "arm_campaign":
        with np.load(out_dir / "data_test.npz") as z:
            test = {k: z[k] for k in z.files}
        batch = arm_campaign.batches_on(test, min(128, len(test["im"])),
                                        dev, torch.float32)[0]
        cov, ckpt = arm_campaign.COV, out_dir / "eps_bounded_lr1_vars.npz"
    else:
        from dgpmp2_tpu_torch.data import dataset as ds

        roots = [str(r) for r in sorted(out_dir.glob("data_*"))]
        n = len(ds.PlanningDatasetMulti(roots, mode="test"))
        batch = learned_campaign.load_test_batches(roots, min(128, n), dev,
                                                   torch.float32)[0]
        cov, ckpt = learned_campaign.COV, out_dir / "eps_bounded_vars.npz"
    fresh = planner.init_variables(
        torch.Generator().manual_seed(1),
        planner.stack_inputs(batch["im"], batch["sdf"]), batch["th_opt"])
    reloaded = checkpoints.load_flat_variables(str(ckpt), fresh)
    fixed = fixed_params(planner.spec, planner.robot, batch, cov)
    th0 = straight(planner.spec, batch["start"], batch["goal"])
    with torch.no_grad():
        a, b = (planner.plan(v, fixed, th0, batch["sdf"], batch["im"],
                             max_iters=50, track_best=True)[0]
                for v in (state.variables, reloaded))
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: the reloaded {ckpt.name} plans "
                             f"{float((a - b).abs().max()):.3e} apart")
    print(f"{name}: {ckpt.name} reloaded plans bit-equal to the model in "
          f"memory (B={a.shape[0]}, 50 iterations, track_best)")


def check_tool_counts(name, counts, rec, norms=0):
    """The kernels of a tool's path: K-BTD at least a solve per counted
    ``gn.plan`` iteration; K-LOOKUP3D only in the 3-D tools, K-LOOKUP in
    the others; K-LOOKUP-BWD only where a tool trains; K-LOOKUP-LIMB and
    its splits never; K-NORM ``norms`` launches, the count of
    :func:`counting_norms`."""
    tool = name.split()[0]
    ok = (counts["btd_solve"] >= max(rec["iters"], 1)
          and counts["sdf_lookup_limbs"] == 0 and counts["limb_splits"] == 0
          and (counts["sdf_lookup3d"] > 0) == (tool in TOOLS_3D)
          and (counts["sdf_lookup"] > 0) != (tool in TOOLS_3D)
          and (counts["sdf_lookup_bwd"] > 0) == (tool in TOOLS_TRAINING)
          and counts["encoder_norm"] == norms)
    if not ok:
        raise AssertionError(f"{name}: launches {counts} with "
                             f"{rec['iters']} counted gn.plan iterations and "
                             f"{norms} K-NORM launches of its encoders")


PLAN3D_GAP = 0.05  # 4 problems of 80


def plan3d_against_tpu(smi, results):
    """Each family's best-static and ms16 rates beside the JAX tool's
    committed TPU rates (runs/plan3d/results.yaml): quality, not speed."""
    import yaml

    ref = yaml.safe_load((ROOT / "runs" / "plan3d" /
                          "results.yaml").read_text())
    for fam, rows in results.items():
        ms = next(k for k in rows if k.startswith("ms"))
        for row, ref_row in (("best_static", "best_static"), (ms, "ms16")):
            for k in ("solve_rate", "contact_free_rate"):
                got, want = rows[row][k], ref[fam][ref_row][k]
                flag = " (gap > 0.05)" if abs(got - want) > PLAN3D_GAP else ""
                print(f"[{smi}] plan3d_sweep quality {fam} {row} {k}: card "
                      f"{got:.4f} (sigma {rows[row]['sigma']}), committed TPU "
                      f"run {want:.4f} (sigma {ref[fam][ref_row]['sigma']}), "
                      f"gap {got - want:+.4f}{flag}")


def run_tool(name, argv, dev, smi, log_dir):
    """One tool's ``main(argv)`` through :func:`launch_counts` with
    ``core.gn.plan`` counted, its stdout to ``log_dir/<name>.log``; its
    launches checked (:func:`check_tool_counts`) and added to the kernels
    line.  Returns (its result, seconds)."""
    import importlib

    tool = name.split()[0]
    m = importlib.import_module(f"dgpmp2_tpu_torch.tools.{tool}")
    argv = argv + ([] if dev.type == "cuda" else ["--device", str(dev)])
    log = log_dir / f"{name.replace(' ', '_')}.log"
    with counting_plans() as rec, counting_norms() as norms, \
            open(log, "w") as fp:
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(fp):
                out, counts, regimes = launch_counts(lambda: m.main(argv))
        except BaseException:
            fp.flush()
            print(log.read_text()[-6000:])
            raise
        wall = time.perf_counter() - t0
    check_tool_counts(name, counts, rec, norms["launches"])
    add_totals(counts, regimes)
    print(f"[{smi}] tool {name}: {wall:.3f} s wall, {rec['plans']} gn.plan "
          f"calls of {rec['iters']} iterations; launches "
          f"{json.dumps({k: counts[k] for k in KERNELS})}", flush=True)
    return out, wall


def campaigns(dev, smi, root=None):
    """Phase 18: the eight tools of ``dgpmp2_tpu_torch/tools/`` in process
    through their ``main()`` on the card in float32, into one temporary
    directory, in the order of :func:`tool_runs`.  Widths are the tools'
    own (T=100, 128² and the head of the 2-D campaign, training batch 128;
    48³ and T=30 in ``plan3d_sweep``; 32³, T=20 and batch 16 in
    ``learn3d_campaign``; the 2-link arm at T=40, batch 128); depth is cut:

    (a) ``learned_campaign``: multi_obs and forest, 40 + 16 worlds a family
        of 4 problems (the tool's 250 + 40), 2 epochs (80), validation
        every epoch (10), the eps_bounded config (all 14): one pooled test
        batch of 128, one of 64 a family;
    (b) ``multistart_sweep`` on (a)'s data at the midi composition of
        ``headline_campaign`` (K=32, amp 2.0, batch 32, pruned at 10
        iterations to 8), sigmas 0.01, 0.02, 0.05 (nine); then the learned
        pass on (a)'s checkpoint; then forest with 2 RRT* seeds of 0.2 s a
        problem (1.0 s);
    (c) ``init_experiment`` on (a)'s forest data: 2 epochs (60), batch 32
        (128: (a)'s 160 forest training problems leave no full batch of 128
        after the validation split), K=16, with (a)'s checkpoint;
    (d) ``arm_campaign``: 256 + 128 problems (2048 + 512), 2 epochs (40),
        eps_bounded_lr1 (two configs); the expert's chunk of 512 worlds
        stays;
    (e) ``arm_multistart_eval`` on (d): K=16 with (d)'s checkpoint;
    (f) ``plan3d_sweep`` at its defaults, uncut (20 worlds x 4 problems a
        family); its rates printed beside the committed TPU run's;
    (g) ``learn3d_campaign``: boxes3d, 16 + 16 worlds (60 + 16), 2 epochs
        (10);
    (h) ``headline_campaign --scale smoke``: the whole chain at the smoke
        scale's own sizes (T=30, batch 8).

    Each run's launch counters are zeroed before it and read after
    (:func:`run_tool`); its files, YAML keys and numbers are checked
    (:func:`check_tool_files`); a trained checkpoint reloads and plans
    bit-equal (:func:`check_reload`).  Returns the seconds by tool."""
    import tempfile

    from dgpmp2_tpu_torch.tools import arm_campaign, learned_campaign

    phase("18 campaigns and sweeps")
    t_phase = time.perf_counter()
    log_dir = ROOT / "build" / "campaigns"
    log_dir.mkdir(parents=True, exist_ok=True)
    # The trainers whose train_config a run calls (headline_campaign
    # through learned_campaign).
    trainers = {"learned_campaign": learned_campaign,
                "headline_campaign": learned_campaign,
                "arm_campaign": arm_campaign}
    walls, outs = {}, {}
    with tempfile.TemporaryDirectory(prefix="dgpmp2_campaigns_",
                                     dir=root) as tmp:
        for name, argv in tool_runs(Path(tmp)):
            with (capturing(trainers[name], "train_config")
                  if name in trainers else contextlib.nullcontext([])
                  ) as trained:
                outs[name], walls[name] = run_tool(name, argv, dev, smi,
                                                   log_dir)
            out_dir = Path(argv[argv.index("--out") + 1])
            files = check_tool_files(name, out_dir)
            print(f"{name}: wrote {', '.join(files)}")
            if trained:
                planner, state = trained[-1][:2]
                check_reload(name, planner, state, out_dir, dev)
        plan3d_against_tpu(smi, outs["plan3d_sweep"])
    print(f"[{smi}] phase 18: {time.perf_counter() - t_phase:.2f} s "
          f"({sum(walls.values()):.2f} s in the tools)", flush=True)
    return walls


def _leaves(tree, path=""):
    """(path, array) of each leaf of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


# -- phase 19: the stream and df32 engines -------------------------------------

GOLDEN_REF = ROOT / "tests" / "goldens" / "golden_ref_step.npz"
# K-STREAM against its plain version: relative, in float64.  The float32
# instance: within twice the standard float32 engine's error (assembly,
# damping and K-BTD) against the float64 solve of the same float32
# residuals, plus 1e-7.  The mixed (df32) instance: that float64 solve
# rounded to float32, within STREAM_TOL64 relative beyond half a float32
# spacing.
STREAM_TOL64 = 1e-10
# Edge shapes: a lone problem and a batch that leaves the last warp partly
# empty; one GP factor (T1 = 2 states) and the arms' T1 = 41.
STREAM_EDGES = tuple((b, t) for b in (1, 1000) for t in (2, 41))
# Phase 8's paths whose K-STREAM step is checked, beside the 2-D and 3-D
# benches (every family: nonholonomic, self-collision and joint limits, the
# workspace goal, GP interpolation and velocity limits; D = 4, 6, 8, 18, 34).
STREAM_PATHS = ("heading robot", "2-link arm", "task-space 3-link arm",
                "GP interpolation + velocity limits", "4-link arm",
                "9-link arm", "17-link arm")
ENGINE_ITERS = 100  # the 2-D main path's iterations (bench.py's)


def cast_params(params, dtype):
    """GraphParams in ``dtype``, each broadcast dimension kept stride 0."""
    import dataclasses

    from dgpmp2_tpu_torch.core import stream

    return type(params)(**{
        f.name: None if (v := getattr(params, f.name)) is None
        else stream._compact(v).to(dtype).expand(v.shape)
        for f in dataclasses.fields(params)})


def rounded_err(xm, x64):
    """How far the float32 ``xm`` lies from the float64 ``x64`` beyond half
    a float32 spacing (the upper one) at each element, over max |x64|: at
    most 0 where ``xm`` is ``x64`` rounded to float32."""
    r = x64.abs().float()
    half = (torch.nextafter(r, torch.full_like(r, float("inf"))) - r) / 2
    over = (xm.double() - x64).abs() - half.double()
    return float(over.max()) / float(x64.abs().max())


# K-STREAM's instances: name -> (blocks' dtype, residuals' dtype).
STREAM_INSTANCES = {"float32": (torch.float32, torch.float32),
                    "float64": (torch.float64, torch.float64),
                    "mixed (df32)": (torch.float64, torch.float32)}


def stream_args(problem, inst, lam=None, lm=False):
    """(args, kwargs) of K-STREAM's instance ``inst`` (of
    :data:`STREAM_INSTANCES`) on one path's first-iteration residuals:
    float32 residuals and blocks, float64 both (the float32 iterate cast),
    or float32 residuals and float64 blocks; GN with reg 0.1, or LM with the
    damping ``lam`` a problem."""
    from dgpmp2_tpu_torch.core import graph, stream

    spec, robot, params, th, sdf = problem
    dt, rt = STREAM_INSTANCES[inst]
    if rt == torch.float64:
        params = cast_params(params, dt)
        th, sdf = th.double(), sdf.double()
    res = graph.eval_residuals(spec, robot, params, th, sdf)
    ss = stream.build_stream_static(spec, params, None, th.shape[0], dt,
                                    0.0 if lm else 0.1)
    return stream.kernel_args(spec, params, ss, res,
                              None if lam is None else lam.to(dt), lm)


def stream_errors(problem, lam, lm):
    """K-STREAM's three instances on one path's first-iteration residuals:
    (float64 error against plain, float32 instance's and the standard
    float32 engine's max abs error against the float64 solve of the float32
    residuals, the mixed instance's rounded error, the float32 instance's
    max abs error against its own plain version)."""
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as kb
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    spec, robot, params, th, sdf = problem
    a, kw = stream_args(problem, "float64", lam, lm)
    e64 = rel_err(k.launch(*a, **kw), k.plain(*a, **kw))
    del a, kw
    a32, kw32 = stream_args(problem, "float32", lam, lm)
    am, kwm = stream_args(problem, "mixed (df32)", lam, lm)
    x64 = tridiag.btd_solve(*k.plain_system(*am, **kwm))
    x32 = k.launch(*a32, **kw32)
    e32 = float((x32.double() - x64).abs().max())
    e32_plain = float((x32 - k.plain(*a32, **kw32)).abs().max())
    res = graph.eval_residuals(spec, robot, params, th, sdf)
    std = kb.btd_solve_cuda(*gn.damped_system(
        *graph.assemble_from_residuals(spec, params, res),
        lam.float() if lm else 0.1, lm))
    e_std = float((std.double() - x64).abs().max())
    em = rounded_err(k.launch(*am, **kwm), x64)
    return e64, e32, e_std, em, e32_plain


def check_stream(name, problem, rng):
    """:func:`stream_errors` under GN (reg 0.1) and LM (a lambda per problem
    in [1e-4, 10]); raises past the tolerances."""
    b = problem[3].shape[0]
    lam = torch.tensor(10.0 ** rng.uniform(-4, 1, b), device=problem[3].device)
    out = {}
    for lm in (False, True):
        e64, e32, e_std, em, e32p = stream_errors(problem, lam, lm)
        how = "LM" if lm else "GN"
        print(f"K-STREAM {name} (B={b}, T1={problem[0].num_traj_states}, "
              f"D={problem[0].state_dim}) {how}: float64 vs plain {e64:.3e} "
              f"(tol {STREAM_TOL64:g}); float32 vs the float64 solve "
              f"{e32:.3e}, the standard float32 engine's {e_std:.3e} (bound "
              f"{2 * e_std + 1e-7:.3e}); mixed rounded err {em:.3e}; float32 "
              f"vs its plain version {e32p:.3e} abs")
        if not (e64 <= STREAM_TOL64 and e32 <= 2 * e_std + 1e-7
                and em <= STREAM_TOL64):
            raise AssertionError(f"K-STREAM {name} {how}: {e64}, {e32}, "
                                 f"{e_std}, {em}")
        out[how] = e32p
    return out


def stream_system(rng, b, t1, d, inst, dev, lm):
    """(args, kwargs) of K-STREAM for a random damped system at batch
    ``b``, ``t1`` states and D = ``d`` in the instance ``inst`` (of
    :data:`STREAM_INSTANCES`): the per-plan blocks and a K = 3 family's Λ
    shared by the batch (stride 0; the Λ also along time), a diagonal K = 2
    family per problem, and under ``lm`` a damping a problem."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    ta, tr = STREAM_INSTANCES[inst]
    t = t1 - 1

    def ten(x, dt):
        return torch.tensor(x, dtype=dt, device=dev)

    def normal(*shape, scale=1.0):
        return scale * rng.standard_normal(shape)

    g = normal(1, t1, d, d)
    diag = g @ np.swapaxes(g, -1, -2) * 0.1 + 4.0 * np.eye(d)
    w3 = normal(3, 3)
    w3 = w3 @ w3.T * 0.2 + np.eye(3)
    blocks = [diag, normal(1, t, d, d, scale=0.15 * min(1.0, (8 / d) ** 0.5)),
              normal(1, t, d, d, scale=0.5), normal(1, t, d, d, scale=0.5),
              normal(1, d, d, scale=0.5), normal(1, d, d, scale=0.5)]
    res = [normal(b, t, d), normal(b, d), normal(b, d)]
    fams = [k.Family(ten(normal(b, t1, 3, d, scale=0.5), tr),
                     ten(normal(b, t1, 3), tr), ten(w3[None, None], ta)),
            k.Family(ten(normal(b, t1, 2, d, scale=0.5), tr),
                     ten(normal(b, t1, 2), tr),
                     ten(rng.uniform(0.1, 1.0, (b, t1, 2)), ta), True)]
    delta = ten(10.0 ** rng.uniform(-3, 0, b), ta) if lm else None
    return ((*(ten(x, ta) for x in blocks), *(ten(x, tr) for x in res),
             fams), dict(delta=delta))


def stream_system_err(args, kw):
    """(error, bound) of one K-STREAM launch on :func:`stream_system`'s
    system, as phase 19 (a) holds the paths: float64 relative to the plain
    version, 1e-10; mixed beyond half a float32 spacing of the float64
    solve, 1e-10; float32 max abs against the float64 solve, within twice
    the float32 plain assembly solved by K-BTD, plus 1e-7."""
    import dataclasses

    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as kb
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    x = k.launch(*args, **kw)
    if args[6].dtype == torch.float64:
        return rel_err(x, k.plain(*args, **kw)), STREAM_TOL64
    fams = [dataclasses.replace(f, w=f.w.double()) for f in args[9]]
    a64 = (*(a.double() for a in args[:6]), *args[6:9], fams)
    kw64 = {n: None if v is None else v.double() for n, v in kw.items()}
    x64 = tridiag.btd_solve(*k.plain_system(*a64, **kw64))
    if args[0].dtype == torch.float64:
        return rounded_err(x, x64), STREAM_TOL64
    std = kb.btd_solve_cuda(*k.plain_system(*args, **kw))
    e_std = float((std.double() - x64).abs().max())
    return float((x.double() - x64).abs().max()), 2 * e_std + 1e-7


def stream_ring_edges(dev, rng, shapes=None):
    """The lane-group kernel at every D <= 16 in its three instances on
    :func:`stream_system`'s systems at the ring's edges: by default a lone
    problem with T1 = 1 (LM), 7 problems with T1 = 2 (GN) and B = 1000 (a
    partly empty last block) with T1 = stages + 1 (GN and LM).  Returns the
    worst error over its bound."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    worst = 0.0
    for inst, dtypes in STREAM_INSTANCES.items():
        for d in range(1, BTD_NARROW + 1):
            cases = shapes or (
                (1, 1, True), (7, 2, False),
                *((1000, k.geometry(d, 1000, k.KINDS[dtypes])["stages"] + 1,
                   lm) for lm in (False, True)))
            for b, t1, lm in cases:
                e, tol = stream_system_err(
                    *stream_system(rng, b, t1, d, inst, dev, lm))
                if not e <= tol:
                    raise AssertionError(f"K-STREAM {inst} D={d} B={b} "
                                         f"T1={t1} {'LM' if lm else 'GN'}: "
                                         f"{e} > {tol}")
                worst = max(worst, e / tol)
    return worst


def stream_rows_system(rng, b, t1, d, inst, dev, lm, k_diag, addends):
    """:func:`stream_system` for the wide and block kernels' edges: the
    per-plan blocks shared at batch stride 0, a K = 3 family with a Λ every
    problem and step shares, a K = 4 family with a full Λ per problem and
    step, a diagonal family of ``k_diag`` rows with a Λ per problem, and
    with ``addends`` a diag, off and rhs addend per problem."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    args, kw = stream_system(rng, b, t1, d, inst, dev, lm)
    ta, tr = STREAM_INSTANCES[inst]

    def ten(x, dt):
        return torch.tensor(x, dtype=dt, device=dev)

    w4 = rng.standard_normal((b, t1, 4, 4))
    w4 = w4 @ np.swapaxes(w4, -1, -2) * 0.2 + np.eye(4)
    fams = [args[9][0],
            k.Family(ten(0.5 * rng.standard_normal((b, t1, 4, d)), tr),
                     ten(rng.standard_normal((b, t1, 4)), tr), ten(w4, ta)),
            k.Family(ten(0.5 * rng.standard_normal((b, t1, k_diag, d)), tr),
                     ten(rng.standard_normal((b, t1, k_diag)), tr),
                     ten(rng.uniform(0.1, 1.0, (b, t1, k_diag)), ta), True)]
    if addends:
        g = 0.1 * rng.standard_normal((b, t1, d, d))
        kw.update(diag_add=ten(g @ np.swapaxes(g, -1, -2), ta),
                  off_add=ten(0.05 * rng.standard_normal((b, t1 - 1, d, d)),
                              ta),
                  rhs_add=ten(rng.standard_normal((b, t1, d)), ta))
    return (*args[:9], fams), kw


# The wide and block kernels' D at their edges (phase 19 (a)).
ROWS_EDGE_D = (17, 18, 32, 33, 34)


def stream_rows_edges(dev, rng, ds=ROWS_EDGE_D, insts=tuple(STREAM_INSTANCES)):
    """The wide and block kernels at each D of ``ds`` in the instances
    ``insts`` on :func:`stream_rows_system`'s systems at their stages' and
    chunks' edges, under their default plan and under 2 stages of 16 rows
    (``btd_stream.set_rows_plan``): a lone problem with T1 = 1 (LM) and a
    diagonal family of 1 row, 7 problems with T1 = 2 and chunk - 1 rows,
    7 with T1 = stages + 1 and chunk rows (LM), 1000 with T1 = stages + 1
    and chunk + 1 rows, and 1000 with T1 = 3 and 411 rows (LM), every
    addend on the odd cases; one launch each.  Returns the worst error
    over its bound."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    worst = 0.0
    for caps in ({}, {"stages": 2, "chunk_rows": 16}):
        prev = k.set_rows_plan(**caps)
        try:
            for inst in insts:
                kind = k.KINDS[STREAM_INSTANCES[inst]]
                for d in ds:
                    fams = (k.FamilyShape(3, False, True),
                            k.FamilyShape(4, False, False),
                            k.FamilyShape(411, True, False))
                    g = k.geometry(d, 1000, kind, families=fams)
                    ck, st = g["chunk_rows"], g["stages"]
                    cases = ((1, 1, True, 1), (7, 2, False, ck - 1),
                             (7, st + 1, True, ck), (1000, st + 1, False,
                                                     ck + 1),
                             (1000, 3, True, 411))
                    for i, (b, t1, lm, kd) in enumerate(cases):
                        args, kw = stream_rows_system(rng, b, t1, d, inst,
                                                      dev, lm, max(kd, 1),
                                                      i % 2 == 1)
                        n = k.launches
                        e, tol = stream_system_err(args, kw)
                        if k.launches - n != 1 or not e <= tol:
                            raise AssertionError(
                                f"K-STREAM {inst} D={d} B={b} T1={t1} "
                                f"K={kd} caps {caps}: {e} > {tol} "
                                f"({k.launches - n} launches)")
                        worst = max(worst, e / tol)
        finally:
            k.set_rows_plan(**prev)
    return worst


def stream_bound(args, kw, x):
    """(ms, by) of one K-STREAM step: its inputs read once (each block as
    stored: a shared one once), x written once; operations per step and
    problem: the GP/prior rhs (4 D² + 2 D² at the ends), per family and
    residual row ΛH (2 K D, or D diagonal), the lower triangle's products
    and rhs (D (D + 1) + 2 D), then K-BTD's sweep (:func:`btd_flops`)."""
    from dgpmp2_tpu_torch.core import stream

    tensors = [*args[:9], *(v for v in kw.values() if v is not None)]
    fams = args[9]
    for f in fams:
        tensors += [f.h, f.r, f.w]
    nbytes = sum(stream._compact(t).numel() * t.element_size()
                 for t in (*tensors, x))
    b, t1, d = x.shape
    per = 4 * d * d
    for f in fams:
        k = f.h.shape[-2]
        per += k * ((d if f.diagonal else 2 * k * d) + d * (d + 1) + 2 * d)
    flops = b * (t1 * per + btd_flops(t1, d))
    return bound(nbytes, flops, args[0].dtype)


def time_stream(label, problem, smi, rec=None, timing=None):
    """K-STREAM's three instances timed on one path's first GN step (reg
    0.1) beside the standard engine's assembly + damping + K-BTD; ``timing``
    the counts of :func:`kernel_ms` (:data:`ARM_TIMING` for the arms)."""
    timing = timing or {}
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    spec, robot, params, th, sdf = problem
    b = th.shape[0]
    for inst in STREAM_INSTANCES:
        a, kw = stream_args(problem, inst)
        r = {}
        kernel_ms(r, lambda: k.launch(*a, **kw), lambda: k.plain(*a, **kw),
                  "btd_stream_kernel", **timing)
        x = k.launch(*a, **kw)
        r["bound_ms"], r["bound_by"] = stream_bound(a, kw, x)
        print(f"[{smi}] K-STREAM {label} B={b} T1={spec.num_traj_states} "
              f"D={spec.state_dim} {inst}: {times_line(r)}")
        if rec is not None and inst == "float32":
            rec.update({key: r[key] for key in ("ms", "graph_ms", "event_ms",
                                                "host_us", "plain_ms",
                                                "bound_ms", "bound_by")})
        del a, kw, x
    std = standard_step_times(problem, timing)
    seen = (f"{std['busy_ms']:.4f} ms busy in {std['ops']} launches"
            if std["ops"] else "no launch seen")
    print(f"[{smi}] standard engine's step at the {label} (assembly + "
          f"damping + K-BTD, float32): CUDA graph {std['graph_ms']:.4f} ms "
          f"(warm L2), host-inclusive events {std['event_ms']:.4f} ms, "
          f"profiler {seen}; library call: none computes this step")


def standard_step_times(problem, timing=None):
    """The standard engine's float32 step on one path's first-iteration
    residuals (assembly + damping + K-BTD, reg 0.1), the work one K-STREAM
    launch does: its CUDA-graph ms (warm L2), host-inclusive event ms, and
    the profiler's device-busy ms and launches of one step."""
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as kb

    timing = timing or {}
    spec, robot, params, th, sdf = problem
    res = graph.eval_residuals(spec, robot, params, th, sdf)
    static = graph.assemble_static(spec, params, torch.float32)
    reg = torch.tensor(0.1, device=th.device)  # capture refuses a host copy

    def standard():
        return kb.btd_solve_cuda(*gn.damped_system(
            *graph.assemble_from_residuals(spec, params, res, static=static),
            reg))

    ev = cuda_ms(standard, reps=timing.get("reps", 20), flush=True)
    _, prof = profile_run(standard)
    return {"graph_ms": graph_ms(standard, n=timing.get("graph_n", 100)),
            "event_ms": ev, "busy_ms": prof["busy_ms"], "ops": prof["ops"]}


# Phase 8's arms whose K-STREAM step phase 19 (c) times beside the benches:
# one shape of each kernel past the 2-D and 3-D benches' lane groups (D = 8,
# the wide kernel's 18, the block kernel's 34), with :func:`kernel_ms`'s
# counts cut for steps of up to ~15 ms.
STREAM_TIMED_ARMS = ("4-link arm", "9-link arm", "17-link arm")
ARM_TIMING = dict(reps=10, graph_n=10, host_n=50)


def stream_digests(dev) -> dict:
    """sha256 of K-STREAM's x in each instance, under GN and LM, on each of
    phase 19 (a)'s systems (the 2-D and 3-D benches, phase 8's paths, the
    edge shapes), each LM damping drawn as there: two trees' K-STREAM held
    bit-equal (``tools/time_kernels.py --stream-digest``)."""
    import hashlib

    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k

    bench_np = bench_inputs(B)
    imgs, start, goal = bench_np
    problems = {name: problem_of(*v) for name, v in
                constrained_problems(dev, bench_np).items()}
    paths = {"2-D bench": port_problem(*bench_np, dev, torch.float32),
             "3-D bench": port_problem(*bench3d_inputs(B, dev), dev,
                                       torch.float32),
             **{name: problems[name] for name in STREAM_PATHS}}
    for b, t1 in STREAM_EDGES:
        paths[f"edge B={b} T1={t1}"] = port_problem(
            imgs[:b], start[:b], goal[:b], dev, torch.float32, t=t1 - 1)
    rng = np.random.default_rng(19)
    out = {}
    for name, problem in paths.items():
        b = problem[3].shape[0]
        lam = torch.tensor(10.0 ** rng.uniform(-4, 1, b), device=dev)
        for lm in (False, True):
            for inst in STREAM_INSTANCES:
                a, kw = stream_args(problem, inst, lam, lm)
                x = k.launch(*a, **kw).cpu().numpy()
                out[f"{name} {'LM' if lm else 'GN'} {inst}"] = (
                    hashlib.sha256(x.tobytes()).hexdigest())
        torch.cuda.empty_cache()
    return out


def engine_plans(dev, smi, bench, bench3, bench_np):
    """19 (b): the 2-D bench through ``DiffGPMP2Planner.plan`` from the
    YAMLs with ``engine`` stream and df32 (100 iterations), the 3-D bench
    with stream; one K-STREAM launch a GN iteration, no K-BTD launch."""
    from dgpmp2_tpu_torch.core import gn

    imgs, start, goal = bench_np
    yamls2 = ("gpmp2_2d_params.yaml", "robot_2d.yaml", "env_2d_params.yaml")
    yamls3 = ("gpmp2_3d_params.yaml", "robot_3d.yaml", "env_3d_params.yaml")
    for engine in ("stream", "df32"):
        planner = yaml_planner(dev, yamls2, opt=dict(engine=engine,
                                                     max_iters=ENGINE_ITERS))
        n = planner.cfg.max_iters
        out, _ = drive(f"19 (b) 2-D engine={engine}",
                       lambda: planner.plan(bench[3], start, goal, bench[4]),
                       {"btd_stream": n, "sdf_lookup": n + 1})
        check_plan(f"2-D DiffGPMP2Planner.plan (YAMLs, engine={engine})", out,
                   n)
    planner = yaml_planner(dev, yamls3, opt=dict(engine="stream"))
    n = planner.cfg.max_iters
    occ, start3, goal3 = bench3d_inputs(B, dev)
    out, _ = drive("19 (b) 3-D engine=stream",
                   lambda: planner.plan(bench3[3], start3, goal3, bench3[4]),
                   {"btd_stream": n, "sdf_lookup3d": n + 1})
    check_plan("3-D DiffGPMP2Planner.plan (YAMLs, engine=stream)", out, n, 3)
    # Launches per iteration (profiler), and ms per iteration (CUDA events,
    # host-paced), of each engine on the 2-D bench.
    for engine in ("standard", "stream", "df32"):
        ops = {}
        for n in (20, 40):
            cfg = gn.OptimConfig(reg=0.1, max_iters=n, tol_delta=0.0,
                                 engine=engine)
            _, prof = profile_run(lambda: gn.plan(*bench, cfg))
            ops[n] = prof
        per = (ops[40]["ops"] - ops[20]["ops"]) / 20
        busy = (ops[40]["busy_ms"] - ops[20]["busy_ms"]) / 20
        t50, t200, ms = iter_ms(lambda n: gn.plan(*bench, gn.OptimConfig(
            reg=0.1, max_iters=n, tol_delta=0.0, engine=engine)))
        print(f"[{smi}] 2-D bench engine={engine}: {per:.1f} launches a GN "
              f"iteration, device busy {busy:.4f} ms an iteration; "
              f"{ms:.4f} ms an iteration "
              f"(host-paced, CUDA events: 50 iterations {t50:.3f} ms, 200 "
              f"{t200:.3f} ms); K-STREAM in the loop "
              f"{json.dumps(ops[40].get('btd_stream'))}")
    arm_engine_plans(dev, smi, bench_np)


# Phase 8's arms that phase 19 (b) plans under the stream and df32 engines.
ENGINE_ARMS = ("9-link arm", "17-link arm")


def arm_engine_plans(dev, smi, bench_np, names=ENGINE_ARMS):
    """19 (b), the arms: phase 8's 9- and 17-link arms (LM, 20 iterations,
    B=1024, float32) through ``DiffGPMP2Planner.plan`` from the YAMLs with
    ``engine`` stream and df32: one K-STREAM launch an iteration and no
    K-BTD launch, every problem improved; then ms per iteration (CUDA
    events: the 20-iteration plan less the 10-iteration one, over 10, each
    the median of 3) and device busy and launches per iteration (the
    profiler, the same difference) of the standard, stream and df32
    engines."""
    import copy
    import dataclasses

    arms = constrained_problems(dev, bench_np)
    for name in names:
        planner, start, goal, _, sdf = arms[name]
        spec = planner.spec
        th0 = seeds(spec, start, goal, dev)
        n = planner.cfg.max_iters

        def with_cfg(**kw):
            q = copy.copy(planner)
            q.cfg = dataclasses.replace(planner.cfg, **kw)
            return q

        for engine in ("stream", "df32"):
            q = with_cfg(engine=engine)
            out, _ = drive(f"19 (b) {name} engine={engine}",
                           lambda q=q: q.plan(th0, start, goal, sdf),
                           {"btd_stream": n, "sdf_lookup": n + 1})
            check_plan(f"{name} DiffGPMP2Planner.plan (YAMLs, "
                       f"engine={engine})", out, n, spec.dof,
                       spec.total_time_step, 1.0)
        for engine in ("standard", "stream", "df32"):
            plans = {m: with_cfg(engine=engine, max_iters=m, tol_delta=0.0)
                     for m in (n // 2, n)}
            prof = {m: profile_run(lambda q=q: q.plan(th0, start, goal,
                                                      sdf))[1]
                    for m, q in plans.items()}
            t = {m: cuda_ms(lambda q=q: q.plan(th0, start, goal, sdf),
                            reps=3, warmup=2) for m, q in plans.items()}
            k = n - n // 2
            busy = (prof[n]["busy_ms"] - prof[n // 2]["busy_ms"]) / k
            per = (prof[n]["ops"] - prof[n // 2]["ops"]) / k
            ms = (t[n] - t[n // 2]) / k
            kern = prof[n].get("btd_stream" if engine != "standard"
                               else "btd_solve")
            print(f"[{smi}] {name} (D={spec.state_dim}, B={B}, LM) "
                  f"engine={engine}: {ms:.4f} ms an iteration (CUDA events: "
                  f"{n // 2} iterations {t[n // 2]:.3f} ms, {n} {t[n]:.3f} "
                  f"ms), device busy {busy:.4f} ms an iteration, {per:.1f} "
                  f"launches an iteration; its solve kernel in the loop "
                  f"{json.dumps(kern)}")
        del arms[name]
        torch.cuda.empty_cache()


def df32_goldens(dev, smi):
    """The mixed instance on ``tests/goldens/golden_ref_step.npz`` env 1, 12
    iterates along the float64 path: the df32 step within 1e-4 of the
    float64 step and within 2x the floor (float32 residuals, float64
    assembly and solve) + 1e-7, as tests/test_twofloat.py holds JAX's."""
    from dgpmp2_tpu_torch.core import df32, gn, graph
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.robots import PointRobot2D

    g = np.load(GOLDEN_REF)
    spec = graph.GraphSpec(total_time_step=int(g["total_time_step"]),
                           total_time_sec=float(g["total_time_sec"]),
                           x_lims=tuple(float(v) for v in g["x_lims"]),
                           y_lims=tuple(float(v) for v in g["y_lims"]))
    robot = PointRobot2D(sphere_radii=(float(g["sphere_radius"]),))

    def params(dtype):
        return graph.default_params(
            spec, robot, torch.tensor(g["start_1"], dtype=dtype, device=dev),
            torch.tensor(g["goal_1"], dtype=dtype, device=dev),
            qc_inv=g["qc_inv"], cost_sigma=float(g["cost_sigma"]),
            epsilon_dist=float(g["epsilon_dist"]), k_s=g["k_s"],
            k_g=g["k_g"], dtype=dtype)

    p64, p32 = params(torch.float64), params(torch.float32)
    sdf64 = torch.tensor(g["sdf_1"], device=dev)[None]
    sdf32 = sdf64.float()
    th = torch.tensor(g["th_1"][0], device=dev)
    reg = float(g["reg"])
    worst = 0.0
    sdf_ops.set_oob_mode("reference")
    try:
        for i in range(12):
            th32 = th.float()
            dth64 = gn.gn_step(spec, robot, p64, th, sdf64, reg)
            d_df = df32.df32_gn_step(spec, robot, p32, th32, sdf32, reg)
            res = graph.eval_residuals(spec, robot, p32, th32, sdf32)
            d_fl = df32.floor_step(spec, p32, res, reg)
            e_df = float((d_df.double() - dth64).abs().max())
            e_fl = float((d_fl - dth64).abs().max())
            worst = max(worst, e_df)
            if not e_df <= 2.0 * e_fl + 1e-7:
                raise AssertionError(f"df32 golden iterate {i}: {e_df}, "
                                     f"{e_fl}")
            th = th + dth64
    finally:
        sdf_ops.set_oob_mode("intended")
    print(f"df32 on golden_ref_step env 1, 12 iterates: worst |dθ_df32 - "
          f"dθ64| {worst:.3e} (tol 1e-4), each within 2x the floor + 1e-7")
    if not worst <= 1e-4:
        raise AssertionError(f"df32 golden: {worst}")


def stream_gradient(dev, bench_np, b=64, iters=5):
    """19 (d): the float64 gradient of a 5-iteration stream plan with
    respect to obs_inv and q_inv (B=64) on the card against the CPU's."""
    import dataclasses

    from dgpmp2_tpu_torch.core import gn

    imgs, start, goal = bench_np
    b = min(b, len(imgs))
    w = np.random.default_rng(19).standard_normal((b, T + 1, 4))
    grads = []
    for where in (dev, torch.device("cpu")):
        spec, robot, params, th, sdf = port_problem(
            imgs[:b], start[:b], goal[:b], where, torch.float64)
        obs = params.obs_inv.clone().requires_grad_(True)
        q = params.q_inv.clone().requires_grad_(True)
        out = gn.plan(spec, robot, dataclasses.replace(
            params, obs_inv=obs, q_inv=q), th, sdf, gn.OptimConfig(
            reg=0.1, max_iters=iters, tol_delta=0.0, engine="stream"))
        (torch.sum(out.th * torch.tensor(w, device=where))
         + torch.sum(out.err_ext_per_iter)).backward()
        grads.append((obs.grad.cpu(), q.grad.cpu()))
    errs = [rel_err(g, c) for g, c in zip(*grads)]
    print(f"19 (d) float64 gradient of a {iters}-iteration stream plan "
          f"(B={b}) on the card against the CPU: obs_inv {errs[0]:.3e}, "
          f"q_inv {errs[1]:.3e} (tol 1e-10)")
    if not max(errs) <= 1e-10:
        raise AssertionError(f"stream gradient: {errs}")


def stream_engines(dev, smi, bench, bench3, problems, bench_np, rec):
    """Phase 19: K-STREAM in its three instances against its plain version
    on every path's first-iteration residuals and at the edge shapes; the
    df32 goldens; the main path under both engines at full width; times;
    the stream engine's gradient."""
    phase("19 engines: stream and df32")
    rng = np.random.default_rng(19)
    # (a) The kernel against its plain version.
    paths = {"2-D bench": bench, "3-D bench": bench3,
             **{name: problems[name] for name in STREAM_PATHS}}
    for name, problem in paths.items():
        e = check_stream(name, problem, rng)
        if name == "2-D bench":
            rec["max_abs_err"] = e["GN"]
        torch.cuda.empty_cache()
    imgs, start, goal = bench_np
    for b, t1 in STREAM_EDGES:
        check_stream(f"edge B={b} T1={t1}", port_problem(
            imgs[:b], start[:b], goal[:b], dev, torch.float32, t=t1 - 1), rng)
    print(f"K-STREAM lane groups, D = 1-16 in three instances at the ring's "
          f"edges (random systems): worst error over its bound "
          f"{stream_ring_edges(dev, rng):.3e}")
    print(f"K-STREAM wide and block kernels, D = "
          f"{', '.join(map(str, ROWS_EDGE_D))} in three instances at their "
          f"stages' and chunks' edges (random systems, every addend): worst "
          f"error over its bound {stream_rows_edges(dev, rng):.3e}")
    df32_goldens(dev, smi)
    # (b) The main path at full width under both engines.
    engine_plans(dev, smi, bench, bench3, bench_np)
    # (c) Times at the 2-D and 3-D benches and the arms.
    time_stream("2-D bench", bench, smi, rec)
    time_stream("3-D bench", bench3, smi)
    for name in STREAM_TIMED_ARMS:
        time_stream(name, problems[name], smi, timing=ARM_TIMING)
        torch.cuda.empty_cache()
    # (d) The gradient.
    stream_gradient(dev, bench_np)


def stream_engines_alone(dev, smi):
    """Phase 19 without phases 3-18: the benches and phase 8's problems
    built here (about 45 s after the build)."""
    bench_np = bench_inputs(B)
    occ, start3, goal3 = bench3d_inputs(B, dev)
    problems = {name: problem_of(*v) for name, v in
                constrained_problems(dev, bench_np).items()}
    stream_engines(dev, smi, port_problem(*bench_np, dev, torch.float32),
                   port_problem(occ, start3, goal3, dev, torch.float32),
                   problems, bench_np, {})


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
        "btd_stream": {
            "source": "dgpmp2_tpu_torch/csrc/btd_stream.cu",
            "replaces": "dgpmp2_tpu/ops/pallas/btd_stream.py:117 and :189 "
                        "with the stream step's assembly "
                        "(dgpmp2_tpu/core/stream.py:219 stream_step)",
            "library_ms": None},
        "encoder_norm": {
            "source": "dgpmp2_tpu_torch/csrc/encoder_norm.cu",
            "replaces": "none: the JAX package leaves flax's LayerNorm, "
                        "ReLU and max-pool to XLA "
                        "(dgpmp2_tpu/models/conv_encoder.py:45 and :74)"},
    }
    for name, rec in recs.items():
        rec.update(name=name, route="cuda")
    check_btd(dev, recs["btd_solve"], bench, smi)
    check_btd_arms(dev, smi, bench_np)
    check_lookup(dev, recs["sdf_lookup"], bench, smi)
    check_lookup3d(dev, recs["sdf_lookup3d"], smi)
    check_encoder_norm(dev, recs["encoder_norm"], smi)
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
    mesh_execution(dev, smi)
    examples(dev, smi)
    campaigns(dev, smi)
    stream_engines(dev, smi, bench, bench3, problems, bench_np,
                   recs["btd_stream"])
    for name, rec in recs.items():
        rec["launches"] = TOTALS.get(name)
    recs["btd_solve"]["launches_by_regime"] = dict(REGIME_TOTALS)
    for rec in recs.values():
        print(f"[{smi}] {rec['name']}: {times_line(rec)}")
    for key, ms in per_iter.items():
        print(f"[{smi}] gn_iter_ms_b1024{key} {ms:.4f}")
    for key, (value, n) in SERVE_METRICS.items():
        print(f"[{smi}] {key} {value:.4f} (n={n} requests)")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "launches_by_regime")
         if k in r}
        for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-process"]:
        # A child of phase 16 (c): rank, world size, port.
        mesh_process(*map(int, sys.argv[2:5]), torch.device("cuda", 0))
    else:
        main()
