"""The 3-D path of dgpmp2_tpu_torch (PointRobot3D in voxel worlds) against
dgpmp2_tpu: robot, factor graph, GN plan and the planner built from the 3-D
YAMLs, float64 on the CPU; and the stored 3-D JAX golden."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.planner import DiffGPMP2Planner as JPlanner
from dgpmp2_tpu.robots import PointRobot3D as JPointRobot3D
from dgpmp2_tpu.utils import config as jconfig
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import PointRobot3D, make_robot
from dgpmp2_tpu_torch.utils import config as tconfig

from _torch_parity import F64, both_problems_3d, np_, params_arrays, world3d

torch.set_num_threads(1)
TOL = 1e-10
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
YAMLS = [CONFIGS / f for f in ("gpmp2_3d_params.yaml", "robot_3d.yaml",
                               "env_3d_params.yaml")]


@pytest.fixture(scope="module")
def problems():
    # cost_sigma 0.2 with a 0.6 margin keeps many hinges active.
    return both_problems_3d(seed=0, b=3, t=16, n=16, cost_sigma=0.2, eps=0.6)


def test_point_robot_3d_fk_and_make_robot():
    th = np.random.default_rng(0).standard_normal((3, 7, 6))
    c_t, j_t = PointRobot3D().fk(torch.tensor(th))
    c_j, j_j = JPointRobot3D().fk(jnp.asarray(th))
    np.testing.assert_array_equal(np_(c_t), np_(c_j))
    np.testing.assert_array_equal(np_(j_t), np_(j_j))
    robot = make_robot({"type": "point_robot_3d", "dof": 3,
                        "sphere_radius": [0.3]})
    assert robot == PointRobot3D(sphere_radii=(0.3,))
    assert (robot.dofs, robot.wksp_dim, robot.state_dim) == (3, 3, 6)


def test_eval_residuals_and_assembly_match_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    r_j = jgraph.eval_residuals(spec_j, robot_j, p_j, th_j, sdf_j)
    r_t = tgraph.eval_residuals(spec_t, robot_t, p_t, th_t, sdf_t)
    for f in dataclasses.fields(r_t):
        a, b = getattr(r_t, f.name), getattr(r_j, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_allclose(np_(a), np_(b), atol=TOL,
                                       err_msg=f.name)
    assert (np_(r_t.r_obs) > 0).any() and r_t.h_obs.shape[-1] == 6
    want = jgraph.assemble_from_residuals(spec_j, p_j, r_j)
    got = tgraph.assemble_from_residuals(spec_t, p_t, r_t)
    for name, a, b in zip(("diag", "off", "rhs"), got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(
        np_(tgraph.error_from_residuals(spec_t, p_t, r_t)),
        np_(jgraph.error_from_residuals(spec_j, p_j, r_j)), rtol=TOL)
    assert spec_t.M == spec_j.M and spec_t.N == spec_j.N


def test_gn_plan_matches_jax(problems):
    """5 fixed-damping GN iterations at D=6: th and both error traces to
    1e-8."""
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    kw = dict(reg=0.1, max_iters=5, tol_delta=0.0)
    r_j = jgn.plan(spec_j, robot_j, p_j, th_j, sdf_j,
                   jgn.OptimConfig(engine="standard", **kw))
    r_t = tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t, tgn.OptimConfig(**kw))
    for name in ("th", "err_init", "err_per_iter", "err_ext_per_iter"):
        np.testing.assert_allclose(np_(getattr(r_t, name)),
                                   np_(getattr(r_j, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    assert (np_(r_t.err_final) < np_(r_t.err_init)).all()


def test_convert_carries_3d_params(problems):
    (_, _, p_j, _, _), (_, _, p_t, _, _) = problems
    again = convert.graph_params_from_numpy(params_arrays(p_j), "cpu", F64)
    assert again.q_inv.shape[-1] == 6 and again.obs_inv.shape[-1] == 1
    for f in dataclasses.fields(again):
        a, b = getattr(again, f.name), getattr(p_t, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(np_(a), np_(b))


def test_planner_from_3d_yamls_matches_jax():
    """DiffGPMP2Planner from the three 3-D YAMLs as they are (GN, reg 0.1,
    T=100, up to 100 iterations with the convergence freeze), B=2 in 16^3
    worlds: the config and the plan to 1e-8."""
    env, pp, gp, obs, opt, robot_data = tconfig.load_params(*YAMLS)
    env_p = {k: env[k] for k in ("x_lims", "y_lims", "z_lims")}
    planner = DiffGPMP2Planner(gp, obs, pp, opt, env_p,
                               make_robot(robot_data), dtype=F64,
                               device="cpu")
    j_env, j_pp, j_gp, j_obs, j_opt, j_rd = jconfig.load_params(*YAMLS)
    j_planner = JPlanner(j_gp, j_obs, j_pp, j_opt, env_p,
                         jconfig.make_robot(j_rd), dtype=jnp.float64)
    for f in ("dof", "state_dim", "total_time_sec", "total_time_step",
              "nlinks", "x_lims", "y_lims", "z_lims", "M"):
        assert getattr(planner.spec, f) == getattr(j_planner.spec, f), f
    assert isinstance(planner.robot, PointRobot3D)

    from dgpmp2_tpu.ops import sdf as jsdf
    from dgpmp2_tpu.utils.trajectory import straight_line_traj

    vox, start, goal = world3d(5, 2, 16)
    sdf = np.asarray(jsdf.sdf_from_occupancy_3d(jnp.asarray(vox), res=10 / 16))
    th0 = np.asarray(straight_line_traj(jnp.asarray(start[:, :3]),
                                        jnp.asarray(goal[:, :3]), 10.0,
                                        planner.spec.total_time_step))
    got = convert.plan_result_to_numpy(planner.plan(th0, start, goal, sdf))
    want = j_planner.plan(th0, start, goal, sdf)
    for name in ("th", "err_init", "err_final", "err_per_iter",
                 "err_ext_per_iter"):
        np.testing.assert_allclose(got[name], np_(getattr(want, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(got["iters"], np_(want.iters))
    assert (got["err_final"] < got["err_init"]).all()


def test_plan3d_matches_the_jax_golden():
    """The stored B=4 16^3 golden, 5 GN iterations in float64 (chip_smoke.py
    repeats it on the card through K-LOOKUP3D): 1e-8 relative."""
    out, g = chip_smoke.golden_plan(torch.device("cpu"), chip_smoke.GOLDEN3D)
    assert g["images"].shape == (4, 16, 16, 16)
    errs = chip_smoke.golden_errors(out, g)
    assert all(v <= 1e-8 for v in errs.values()), errs


def test_validate_grid_checks_z_like_jax():
    lims = (-5.0, 5.0)
    spec_t = tgraph.GraphSpec(dof=3, state_dim=6, z_lims=lims)
    spec_j = jgraph.GraphSpec(dof=3, state_dim=6, z_lims=lims)
    spec_t.validate_grid((2, 16, 16, 16))
    for spec in (spec_t, spec_j):
        with pytest.raises(ValueError, match="z_lims"):
            spec.validate_grid((2, 12, 16, 16))
    with pytest.raises(ValueError, match="inconsistent"):
        tgraph.eval_residuals(
            spec_t, PointRobot3D(), None,
            torch.zeros((1, spec_t.num_traj_states, 6), dtype=F64),
            torch.zeros((1, 12, 16, 16), dtype=F64))
    # The optional factors construct with z_lims set, as in the JAX package.
    kw = dict(dof=3, state_dim=6, z_lims=lims, use_gp_inter=True)
    assert tgraph.GraphSpec(**kw).M == jgraph.GraphSpec(**kw).M
