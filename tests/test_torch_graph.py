"""dgpmp2_tpu_torch factor graph (residuals, assembly, errors) against
dgpmp2_tpu, float64 on the CPU with params carried by ``convert``: 1e-10."""
import dataclasses

import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.robots import PointRobot2D

from _torch_parity import F64, both_problems, np_

torch.set_num_threads(1)
TOL = 1e-10


@pytest.fixture(scope="module")
def problems():
    # cost_sigma 0.2 with a 0.6 margin keeps many hinges active.
    return both_problems(seed=0, b=4, t=16, n=32, cost_sigma=0.2, eps=0.6)


def test_eval_residuals_matches_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    r_j = jgraph.eval_residuals(spec_j, robot_j, p_j, th_j, sdf_j)
    r_t = tgraph.eval_residuals(spec_t, robot_t, p_t, th_t, sdf_t)
    for f in dataclasses.fields(r_t):
        a, b = getattr(r_t, f.name), getattr(r_j, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_allclose(np_(a), np_(b), atol=TOL, err_msg=f.name)
    assert (np_(r_t.r_obs) > 0).any()


def test_assembly_matches_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    r_j = jgraph.eval_residuals(spec_j, robot_j, p_j, th_j, sdf_j)
    r_t = tgraph.eval_residuals(spec_t, robot_t, p_t, th_t, sdf_t)
    want = jgraph.assemble_from_residuals(spec_j, p_j, r_j)
    static = tgraph.assemble_static(spec_t, p_t, F64)
    for got in (tgraph.assemble_from_residuals(spec_t, p_t, r_t),
                tgraph.assemble_from_residuals(spec_t, p_t, r_t,
                                               static=static),
                tgraph.assemble(spec_t, robot_t, p_t, th_t, sdf_t)):
        for name, a, b in zip(("diag", "off", "rhs"), got, want):
            np.testing.assert_allclose(np_(a), np_(b), rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_errors_match_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    r_j = jgraph.eval_residuals(spec_j, robot_j, p_j, th_j, sdf_j)
    r_t = tgraph.eval_residuals(spec_t, robot_t, p_t, th_t, sdf_t)
    np.testing.assert_allclose(
        np_(tgraph.error_from_residuals(spec_t, p_t, r_t)),
        np_(jgraph.error_from_residuals(spec_j, p_j, r_j)), rtol=TOL)
    # Overridden (external) covariances.
    q2, o2 = 2.0 * p_j.q_inv, 3.0 * p_j.obs_inv
    np.testing.assert_allclose(
        np_(tgraph.graph_error(spec_t, robot_t, p_t, th_t, sdf_t,
                               q_inv=torch.tensor(np_(q2)),
                               obs_inv=torch.tensor(np_(o2)))),
        np_(jgraph.graph_error(spec_j, robot_j, p_j, th_j, sdf_j, q_inv=q2,
                               obs_inv=o2)), rtol=TOL)
    np.testing.assert_allclose(
        np_(tgraph.obstacle_residuals(spec_t, robot_t, p_t, th_t, sdf_t)),
        np_(jgraph.obstacle_residuals(spec_j, robot_j, p_j, th_j, sdf_j)),
        atol=TOL)
    assert spec_t.M == spec_j.M and spec_t.N == spec_j.N


def test_default_params_match_the_converted_ones(problems):
    _, (spec_t, robot_t, p_t, th_t, _) = problems
    own = tgraph.default_params(
        spec_t, robot_t, p_t.start, p_t.goal, qc_inv=np.eye(2),
        cost_sigma=0.2, epsilon_dist=0.6, k_s=0.01, k_g=0.01, dtype=F64)
    for f in dataclasses.fields(own):
        a, b = getattr(own, f.name), getattr(p_t, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-14,
                                       err_msg=f.name)
    with pytest.raises(ValueError, match="not GraphParams fields"):
        convert.graph_params_from_numpy({"bogus": np.zeros(1)}, "cpu", F64)


@pytest.mark.parametrize("option", [
    {"non_holonomic": True}, {"use_vel_limits": True},
    {"use_gp_inter": True}, {"use_self_collision": True},
    {"use_joint_limits": True}, {"use_workspace_goal": True},
    {"z_lims": (-5.0, 5.0), "use_vel_limits": True},
])
def test_spec_options_not_ported_raise(option):
    """Every option once refused is ported now: the spec constructs and its
    residual dimension M equals the JAX package's."""
    spec_t = tgraph.GraphSpec(**option, self_pairs=((0, 0),))
    spec_j = jgraph.GraphSpec(**option, self_pairs=((0, 0),))
    assert spec_t.M == spec_j.M and spec_t.num_self_pairs == 1


def test_validate_grid_raises_like_jax():
    spec_t, spec_j = tgraph.GraphSpec(), jgraph.GraphSpec()
    assert spec_t.res(128) == spec_j.res(128)
    spec_t.validate_grid((2, 128, 128))
    for spec in (spec_t, spec_j):
        with pytest.raises(ValueError, match="inconsistent"):
            spec.validate_grid((2, 100, 128))
    with pytest.raises(ValueError, match="inconsistent"):
        tgraph.eval_residuals(
            spec_t, PointRobot2D(), None,
            torch.zeros((1, spec_t.num_traj_states, 4), dtype=F64),
            torch.zeros((1, 100, 128), dtype=F64))
