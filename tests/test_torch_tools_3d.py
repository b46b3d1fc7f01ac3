"""dgpmp2_tpu_torch.tools.plan3d_sweep and learn3d_campaign against the JAX
tools, on the CPU.

``make_problems`` gives the JAX tool's worlds, starts and goals (its numpy
draws) and SDFs to 1e-6 for every voxel family at 32³, and ``judge`` its
verdicts (exactly) and smoothness (1e-12).  ``plan3d_sweep.main`` at 16³, T=6, 2
problems a family in float64 against the JAX tool's procedure built from
the JAX package: every family's per-sigma rows (LM, 50 iterations), its
best static row and its ms16 row (JAX's normals of ``PRNGKey(seed)`` in
the port), rates equal and the smoothness to 1e-8.  ``learn3d_campaign``:
its batches equal the JAX tool's ``load_batches``, its static sweep's rows
the JAX package's LM plans under the JAX tool's judge, and its ``main``
runs end to end (16³, T=6, one epoch).  Both tools' YAMLs are keyed as the
JAX tools' committed ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.robots import PointRobot3D as JPointRobot3D
from dgpmp2_tpu_torch.robots import PointRobot3D
from dgpmp2_tpu_torch.tools import learn3d_campaign as l3
from dgpmp2_tpu_torch.tools import plan3d_sweep as p3

from _torch_tools import (ARGS, F64, close, jax_normals, jax_tool, np_,
                          yaml_of)

torch.set_num_threads(1)
SIZE, T, PROBS = 16, 6, 2
LIMS = (-5.0, 5.0)


def jt():
    return jax_tool("plan3d_sweep")


def j_spec(t=T):
    return jgraph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                            x_lims=LIMS, y_lims=LIMS, z_lims=LIMS)


def test_the_constants_equal_the_jax_tools():
    tool, l3j = jt(), jax_tool("learn3d_campaign")
    assert (p3.LIMS, p3.SIGMAS, p3.EPS) == (tool.LIMS, tool.SIGMAS,
                                             tool.EPS)
    assert (l3.LIMS, l3.SIZE, l3.T, l3.EPS, l3.SIGMAS) == (
        l3j.LIMS, l3j.SIZE, l3j.T, l3j.EPS, l3j.SIGMAS)
    assert l3.COV.keys() == l3j.COV.keys()
    for k, v in l3j.COV.items():
        np.testing.assert_array_equal(l3.COV[k], v)


@pytest.mark.parametrize("family", p3.obstacles3d.FAMILIES3D)
def test_make_problems_matches_jax(family):
    sdf, s, g, res = p3.make_problems(family, 2, PROBS, 32, 3, "cpu", F64)
    sdf_j, s_j, g_j, res_j = jt().make_problems(family, 2, PROBS, 32, 3)
    assert res == res_j
    np.testing.assert_array_equal(s, s_j)
    np.testing.assert_array_equal(g, g_j)
    np.testing.assert_allclose(np_(sdf), np.asarray(sdf_j), rtol=0,
                               atol=1e-6)


def test_judge_matches_jax():
    sdf, s, g, res = p3.make_problems("mixed3d", 2, PROBS, 32, 1, "cpu",
                                      F64)
    th = np.random.default_rng(2).uniform(-5, 5, (sdf.shape[0], T + 1, 6))
    got = p3.judge(None, PointRobot3D(), torch.tensor(th), sdf, res)
    want = jt().judge(None, JPointRobot3D(), jnp.asarray(th),
                      jnp.asarray(np_(sdf)), res)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    close(got[2], want[2], tol=1e-12)


def j_plan3d(seed, restarts):
    """The JAX tool's ``main`` in float64 (its SDFs float32, as the
    tool's): {family: rows}."""
    tool, spec, robot = jt(), j_spec(), JPointRobot3D()
    cfg = jgn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    plan = jax.jit(lambda p, th0, s: jgn.plan(spec, robot, p, th0, s, cfg,
                                              track_best=True).best_th)
    ms = jax.jit(lambda p, th0, s: jms.plan_multistart(
        spec, robot, p, th0, s, cfg, jax.random.PRNGKey(seed),
        restarts=restarts, amp=2.0, prune_iters=10,
        keep=max(2, restarts // 4), select_margin=0.5 * tool.EPS).th)
    results = {}
    for family in p3.obstacles3d.FAMILIES3D:
        sdfb, s, g, res = tool.make_problems(family, 1, PROBS, SIZE, seed)
        sdfb = sdfb.astype(jnp.float64)
        b = sdfb.shape[0]
        startb, goalb = np.zeros((b, 6)), np.zeros((b, 6))
        startb[:, :3], goalb[:, :3] = s, g
        startb, goalb = jnp.asarray(startb), jnp.asarray(goalb)
        th0 = jax_line(spec, startb, goalb)
        rows, best = {}, None
        for sigma in tool.SIGMAS:
            params = jgraph.default_params(
                spec, robot, startb, goalb, qc_inv=np.eye(3),
                cost_sigma=sigma, epsilon_dist=tool.EPS, k_s=0.01, k_g=0.01,
                dtype=jnp.float64)
            row = p3.rates(*tool.judge(spec, robot, plan(params, th0, sdfb),
                                       sdfb, res))
            rows[f"sigma_{sigma}"] = row
            if best is None or row["solve_rate"] > best[1]["solve_rate"]:
                best = (sigma, row, params)
        rows["best_static"] = dict(best[1], sigma=best[0])
        rows[f"ms{restarts}"] = dict(p3.rates(*tool.judge(
            spec, robot, ms(best[2], th0, sdfb), sdfb, res)), sigma=best[0])
        results[family] = rows
    return results


def jax_line(spec, start, goal):
    from dgpmp2_tpu.utils.trajectory import straight_line_traj

    return straight_line_traj(start[:, :3], goal[:, :3], spec.total_time_sec,
                              spec.total_time_step)


def same_rows(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if isinstance(w, dict):
            same_rows(got[k], w, f"{what}/{k}")
        elif k == "avg_vel_mse":
            close(got[k], w, what=f"{what}/{k}")
        else:
            assert got[k] == w, (what, k, got[k], w)


def test_plan3d_main_matches_jax(tmp_path):
    seed, restarts = 0, 16
    with jax_normals([jax.random.PRNGKey(seed)] * 5):
        got = p3.main(["--out", str(tmp_path), "--envs", "1", "--probs",
                       str(PROBS), "--size", str(SIZE), "--t", str(T),
                       "--restarts", str(restarts), "--seed", str(seed),
                       *ARGS])
    same_rows(got, j_plan3d(seed, restarts))
    assert yaml_of(tmp_path / "results.yaml") == got
    chip_smoke.check_tool_files("plan3d_sweep", tmp_path)


@pytest.fixture(scope="module")
def learn3d(tmp_path_factory):
    """``learn3d_campaign.main`` at 16³, T=6, 4 + 2 worlds, one epoch."""
    out = tmp_path_factory.mktemp("learn3d")
    got = l3.main(["--out", str(out), "--family", "boxes3d", "--num_train",
                   "4", "--num_test", "2", "--probs", str(PROBS), "--epochs",
                   "1", "--batch", "2", "--size", str(SIZE), "--t", str(T),
                   *ARGS])
    return out, got


def test_learn3d_main_runs_end_to_end(learn3d):
    out, got = learn3d
    chip_smoke.check_tool_files("learn3d_campaign", out)
    assert yaml_of(out / "results.yaml") == got
    assert len(got["history"]) == 1
    table = (out / "table.md").read_text().splitlines()
    assert table[0].startswith("# 3-D learned covariances — boxes3d, 16³")


def test_learn3d_batches_and_sweep_match_jax(learn3d):
    out, _ = learn3d
    l3j = jax_tool("learn3d_campaign")
    got = l3.load_batches(str(out / "data_test"), 2, "cpu", F64)
    want = l3j.load_batches(str(out / "data_test"), 2)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ("im", "sdf", "start", "goal", "th_opt"):
            np.testing.assert_array_equal(np_(a[k]), np.asarray(b[k]))
    spec_t = p3.graph.GraphSpec(dof=3, state_dim=6, total_time_step=T,
                                x_lims=LIMS, y_lims=LIMS, z_lims=LIMS)
    res = (LIMS[1] - LIMS[0]) / SIZE
    rows = l3.sweep(spec_t, PointRobot3D(), got, res, "test")
    spec, robot = j_spec(), JPointRobot3D()
    cfg = jgn.OptimConfig(reg=0.1, max_iters=50, method="lm")
    plan = jax.jit(lambda p, th0, s: jgn.plan(spec, robot, p, th0, s, cfg,
                                              track_best=True).best_th)
    for sigma in l3.SIGMAS:
        sol, cf = [], []
        for b in got:
            jb = {k: jnp.asarray(np_(b[k])) for k in ("sdf", "start", "goal")}
            params = jgraph.default_params(
                spec, robot, jb["start"], jb["goal"],
                **dict(l3.COV, cost_sigma=sigma), dtype=jnp.float64)
            th = plan(params, jax_line(spec, jb["start"], jb["goal"]),
                      jb["sdf"])
            s, c, _ = jt().judge(spec, robot, th, jb["sdf"], res)
            sol.append(s)
            cf.append(c)
        assert rows[sigma] == {
            "solve_rate": float(np.concatenate(sol).mean()),
            "contact_free_rate": float(np.concatenate(cf).mean())}, sigma
