"""dgpmp2_tpu_torch.DiffGPMP2Planner from the YAML configs against the JAX
planner, float64 on the CPU: 1e-8."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.planner import DiffGPMP2Planner as JPlanner
from dgpmp2_tpu.utils import config as jconfig
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils import config as tconfig

from _torch_parity import F64, np_, world

torch.set_num_threads(1)
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
YAMLS = [CONFIGS / f for f in ("gpmp2_2d_params.yaml", "robot_2d.yaml",
                               "env_2d_params.yaml")]


@pytest.fixture(scope="module")
def setup():
    env, pp, gp, obs, opt, robot_data = tconfig.load_params(*YAMLS)
    env_p = {"x_lims": env["x_lims"], "y_lims": env["y_lims"]}
    robot = make_robot(robot_data)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, env_p, robot, dtype=F64,
                               device="cpu")
    j_env, j_pp, j_gp, j_obs, j_opt, j_rd = jconfig.load_params(*YAMLS)
    j_planner = JPlanner(j_gp, j_obs, j_pp, j_opt, env_p,
                         jconfig.make_robot(j_rd), dtype=jnp.float64)
    imgs, start, goal = world(7, 3, 64)
    from dgpmp2_tpu.ops import sdf as jsdf
    from dgpmp2_tpu.utils.trajectory import straight_line_traj

    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 64))
    th0 = np.asarray(straight_line_traj(jnp.asarray(start[:, :2]),
                                        jnp.asarray(goal[:, :2]), 10.0,
                                        planner.spec.total_time_step))
    return planner, j_planner, (th0, start, goal, sdf)


def test_config_matches_jax(setup):
    planner, j_planner, _ = setup
    for f in ("dof", "state_dim", "total_time_sec", "total_time_step",
              "nlinks", "x_lims", "y_lims", "z_lims", "M"):
        assert getattr(planner.spec, f) == getattr(j_planner.spec, f), f
    for f in ("method", "reg", "max_iters", "tol_err", "tol_delta",
              "engine"):
        assert getattr(planner.cfg, f) == getattr(j_planner.cfg, f), f


def test_planner_plan_matches_jax(setup):
    """The YAML config as it is: GN, reg 0.1, up to 100 iterations with the
    convergence freeze (tol_delta 1e-4)."""
    planner, j_planner, args = setup
    got = convert.plan_result_to_numpy(planner.plan(*args))
    want = j_planner.plan(*args)
    for name in ("th", "err_init", "err_final", "err_per_iter",
                 "err_ext_per_iter"):
        np.testing.assert_allclose(got[name], np_(getattr(want, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(got["iters"], np_(want.iters))
    assert got["best_th"] is None
    assert (got["err_final"] < got["err_init"]).all()


def test_planner_step_and_errors_match_jax(setup):
    planner, j_planner, (th0, start, goal, sdf) = setup
    qc = np.broadcast_to(2.0 * np.eye(2), (3, 100, 2, 2))
    for kw in ({}, {"qc_inv_traj": qc}):
        got = planner.step(th0, start, goal, sdf, **kw)
        want = j_planner.step(th0, start, goal, sdf, **{
            k: jnp.asarray(v) for k, v in kw.items()})
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(np_(got[3].q_inv), np_(want[3].q_inv),
                                   rtol=1e-12)
    np.testing.assert_allclose(np_(planner.error_batch(th0, start, goal, sdf)),
                               np_(j_planner.error_batch(th0, start, goal,
                                                         sdf)), rtol=1e-10)
    np.testing.assert_allclose(
        np_(planner.error_ext_batch(th0, start, goal, sdf)),
        np_(j_planner.error_ext_batch(th0, start, goal, sdf)), rtol=1e-10)
    assert planner.forward == planner.plan
