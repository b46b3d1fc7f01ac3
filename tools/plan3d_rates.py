#!/usr/bin/env python
"""The 3-D sweep's rates in both packages on the CPU, problem by problem.

``dgpmp2_tpu_torch.tools.plan3d_sweep`` (the port) and the JAX tool
``tools/plan3d_sweep.py`` plan the same seeded worlds (the JAX tool's
``make_problems``) at one sigma with LM, 50 iterations and ``track_best``,
and judge them with each tool's ``judge``.  For each family this prints
both packages' solve and contact-free rates, in float32 and float64, and
the problems whose solve verdict differs between them; with
``--multistart`` also the JAX package's ms16 row (``PRNGKey(seed)``, the
JAX tool's staged multistart), whose draws the port's generator does not
repeat.  It explains a gap between the port's rates on a card and a
committed table: a rate both packages share on the CPU belongs to the
problems, not to the port.

    JAX_PLATFORMS=cpu python tools/plan3d_rates.py --families columns \\
        mixed3d [--sigma 0.01] [--envs 20] [--multistart]
"""
import argparse
import importlib.util
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgpmp2_tpu.core import gn as jgn  # noqa: E402
from dgpmp2_tpu.core import graph as jgraph  # noqa: E402
from dgpmp2_tpu.core import multistart as jms  # noqa: E402
from dgpmp2_tpu.robots import PointRobot3D as JRobot  # noqa: E402
from dgpmp2_tpu.utils.trajectory import straight_line_traj  # noqa: E402
from dgpmp2_tpu_torch.core import gn as tgn  # noqa: E402
from dgpmp2_tpu_torch.core import graph as tgraph  # noqa: E402
from dgpmp2_tpu_torch.robots import PointRobot3D as TRobot  # noqa: E402
from dgpmp2_tpu_torch.tools import plan3d_sweep as tp  # noqa: E402


def jax_tool():
    """The JAX tool module, loaded by path (its directory on sys.path only
    while it loads)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_plan3d_sweep", ROOT / "tools" / "plan3d_sweep.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--families", nargs="+",
                   default=list(tp.obstacles3d.FAMILIES3D))
    p.add_argument("--sigma", type=float, default=0.01)
    p.add_argument("--envs", type=int, default=20)
    p.add_argument("--probs", type=int, default=4)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--t", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multistart", action="store_true")
    args = p.parse_args(argv)
    jt = jax_tool()
    lims, eps = jt.LIMS, jt.EPS
    jspec = jgraph.GraphSpec(dof=3, state_dim=6, total_time_step=args.t,
                             x_lims=lims, y_lims=lims, z_lims=lims)
    tspec = tgraph.GraphSpec(dof=3, state_dim=6, total_time_step=args.t,
                             x_lims=lims, y_lims=lims, z_lims=lims)
    cov = dict(qc_inv=np.eye(3), cost_sigma=args.sigma, epsilon_dist=eps,
               k_s=0.01, k_g=0.01)
    jcfg = jgn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    tcfg = tgn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    for fam in args.families:
        sdf, s, g, res = jt.make_problems(fam, args.envs, args.probs,
                                          args.size, args.seed)
        b = sdf.shape[0]
        start, goal = np.zeros((b, 6), np.float32), np.zeros((b, 6),
                                                              np.float32)
        start[:, :3], goal[:, :3] = s, g
        for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                               ("float64", jnp.float64, torch.float64)):
            js, jg = jnp.asarray(start, jdt), jnp.asarray(goal, jdt)
            jsdf = sdf.astype(jdt)
            params = jgraph.default_params(jspec, JRobot(), js, jg, **cov,
                                           dtype=jdt)
            th0 = straight_line_traj(js[:, :3], jg[:, :3],
                                     jspec.total_time_sec, args.t)
            th = jax.jit(lambda p_, t_, s_: jgn.plan(
                jspec, JRobot(), p_, t_, s_, jcfg,
                track_best=True).best_th)(params, th0, jsdf)
            j_solve, j_cf, _ = jt.judge(jspec, JRobot(), th, jsdf, res)
            ts, tg = torch.tensor(start, dtype=tdt), torch.tensor(goal,
                                                                  dtype=tdt)
            tsdf = torch.tensor(np.asarray(sdf), dtype=tdt)
            with torch.no_grad():
                tth = tgn.plan(tspec, TRobot(), tgraph.default_params(
                    tspec, TRobot(), ts, tg, **cov, dtype=tdt),
                    tp.straight(tspec, ts, tg), tsdf, tcfg,
                    track_best=True).best_th
            t_solve, t_cf, _ = tp.judge(tspec, TRobot(), tth, tsdf, res)
            flips = np.flatnonzero(np.asarray(j_solve) != t_solve)
            print(f"{fam} sigma={args.sigma} {name}: JAX solve "
                  f"{np.mean(j_solve):.4f} cf {np.mean(j_cf):.4f}; port "
                  f"solve {np.mean(t_solve):.4f} cf {np.mean(t_cf):.4f}; "
                  f"problems whose solve differs: {flips.tolist()}",
                  flush=True)
        if args.multistart:
            params = jgraph.default_params(jspec, JRobot(),
                                           jnp.asarray(start),
                                           jnp.asarray(goal), **cov,
                                           dtype=jnp.float32)
            th0 = straight_line_traj(jnp.asarray(start[:, :3]),
                                     jnp.asarray(goal[:, :3]),
                                     jspec.total_time_sec, args.t)
            ms = jms.plan_multistart(
                jspec, JRobot(), params, th0.astype(jnp.float32), sdf, jcfg,
                jax.random.PRNGKey(args.seed), restarts=16, amp=2.0,
                prune_iters=10, keep=4, select_margin=0.5 * eps)
            solve, cf, _ = jt.judge(jspec, JRobot(), ms.th, sdf, res)
            print(f"{fam} sigma={args.sigma} float32 JAX ms16: solve "
                  f"{np.mean(solve):.4f} cf {np.mean(cf):.4f}", flush=True)


if __name__ == "__main__":
    main()
