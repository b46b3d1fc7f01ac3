"""dgpmp2_tpu_torch.examples on the CPU in float64: the robots and factors
(velocity limits, GP interpolation, the heading robot, the 2-link arm,
self-collision, the task-space arm), RRT* seeding, multistart and the 3-D
worlds.

As ``test_torch_examples.py``: each example runs once through its ``main``
and must return finite numbers and lower each problem's error, and is held
against the JAX package's functions on the same numpy inputs in float64
(1e-8).  The task-space arm under plain GN is chaotic past a few
iterations (ROADMAP.md Queue 3), so its problem is compared over 3 of
them.  Multistart and the 3-D example draw their perturbations from JAX's
``PRNGKey`` (``core.multistart.inits_from_normals``), as the JAX programs
do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.planner import GPMP2Planner as JGPMP2Planner
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_line
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.examples import _common

from tests._torch_examples import (box_sdf, check_plans, close, env_of,
                                   j_configs, j_diff_planner, j_line_of,
                                   j_params, j_plan, j_spec, module, np_,
                                   run)

torch.set_num_threads(1)
NAMES = ("diff_gpmp2_2d_vel_limits_example", "diff_gpmp2_gp_inter_example",
         "diff_gpmp2_nonholonomic_example", "planar_arm_example",
         "self_collision_example", "arm_taskspace_example",
         "rrt_star_example", "multistart_example", "plan3d_example")


@pytest.mark.parametrize("name", NAMES)
def test_example_plans_on_the_cpu(name):
    check_plans(name)


def test_velocity_limits_match_jax():
    out = run("diff_gpmp2_2d_vel_limits_example")
    m = module("diff_gpmp2_2d_vel_limits_example")
    _, pp, gp, _, _, _ = j_configs()
    pp = dict(pp, use_vel_limits=True)
    planner, _ = j_diff_planner(pp=pp, gp=dict(gp, v_x=m.V_LIM,
                                               v_y=m.V_LIM))
    start, goal = np.asarray([m.START]), np.asarray([m.GOAL])
    r = planner.plan(j_line_of(start, goal, pp), start, goal,
                     box_sdf()[None])
    close(out["th"], r.th)
    close(out["err_final"], r.err_final)


def test_gp_interpolation_matches_jax():
    out = run("diff_gpmp2_gp_inter_example")
    m = module("diff_gpmp2_gp_inter_example")
    env, pp, gp, obs, opt, robot_data = j_configs()
    pp = dict(pp, total_time_step=m.T, total_check_step=m.CHECKS)
    img, res = m.wall_world()
    sdf = np_(_common.occupancy_sdf(img, res, "cpu", torch.float64))[None]
    start = np.asarray([[-4.0, 0.3, 0.0, 0.0]])
    goal = np.asarray([[4.0, 0.3, 0.0, 0.0]])
    robot = jr.make_robot(dict(robot_data, sphere_radius=[0.2]))
    for use_inter in (False, True):
        planner, _ = j_diff_planner(pp=dict(pp, use_gp_inter=use_inter),
                                    obs=dict(obs, epsilon_dist=0.3),
                                    robot=robot)
        r = planner.plan(j_line_of(start, goal, pp), start, goal, sdf)
        got = out[f"gp_inter_{use_inter}"]
        close(got["th"], r.th, what=str(use_inter))
        close(got["err_final"], r.err_final, what=str(use_inter))


def test_nonholonomic_matches_jax():
    out = run("diff_gpmp2_nonholonomic_example")
    m = module("diff_gpmp2_nonholonomic_example")
    planner, pp = j_diff_planner(plan_yaml="gpmp2_xyh_params.yaml",
                                 robot=jr.PointRobotXYH(sphere_radii=(0.4,)))
    start, goal = np.asarray([m.START]), np.asarray([m.GOAL])
    r = planner.plan(j_line_of(start, goal, pp, dof=3), start, goal,
                     box_sdf()[None])
    close(out["th"], r.th)
    close(out["err_final"], r.err_final)


def test_planar_arm_matches_jax():
    out = run("planar_arm_example")
    m = module("planar_arm_example")
    spec, arm, params, th0, sdf, _ = m.problem("cpu", torch.float64)
    r = j_plan(spec, arm, params, th0, sdf, m.CFG)
    close(out["th"], r.th)
    close(out["err_final"], r.err_final)
    assert np.array_equal(np_(out["iters"]), np.asarray(r.iters))


def test_self_collision_matches_jax():
    out = run("self_collision_example")
    m = module("self_collision_example")
    specs, th0, sdf, _ = m.problems("cpu", torch.float64)
    for name, (spec, params) in specs.items():
        r = j_plan(spec, m.ARM, params, th0, sdf, m.CFG)
        close(out[f"factor_{name}"]["th"], r.th, what=name)
        close(out[f"factor_{name}"]["err_final"], r.err_final, what=name)


def test_arm_taskspace_problem_matches_jax_over_three_iterations():
    m = module("arm_taskspace_example")
    spec, arm, params, th0, sdf, _, _ = m.problem("cpu", torch.float64)
    cfg = tgn.OptimConfig(reg=0.1, max_iters=3)
    got = tgn.plan(spec, arm, params, th0, sdf, cfg)
    want = j_plan(spec, arm, params, th0, sdf, cfg)
    close(got.th, want.th)
    close(got.err_per_iter, want.err_per_iter)


def test_arm_taskspace_under_lm_meets_its_claims_and_matches_jax():
    """``--method lm``, the method the card runs it with: its claims hold
    and its 80 LM iterations equal JAX's."""
    out = run("arm_taskspace_example", "--method", "lm")
    check_plans("arm_taskspace_example", out)
    m = module("arm_taskspace_example")
    spec, arm, params, th0, sdf, _, _ = m.problem("cpu", torch.float64)
    want = j_plan(spec, arm, params, th0, sdf,
                  dataclasses.replace(m.CFG, method="lm"))
    close(out["th"], want.th)
    close(out["err_final"], want.err_final)


def test_multistart_with_jax_normals_matches_jax():
    """At 10 GN iterations: plans in this clutter part from JAX's at
    ~1e-9 by 10 iterations and by whole metres by 40 (float64, the same
    for the unperturbed seed: a chaotic basin, not a fault)."""
    out = run("multistart_example", "--max_iters", "10")
    m = module("multistart_example")
    env, pp, gp, obs, _, robot_data = j_configs()
    pp = dict(pp, total_time_step=m.T)
    img, start, goal = m.clutter()
    sdf = np_(_common.occupancy_sdf(img, 10.0 / m.IMSIZE, "cpu",
                                    torch.float64))
    sdfb = jnp.asarray(np.broadcast_to(sdf, (m.B,) + sdf.shape))
    planner = JGPMP2Planner(gp, obs, pp, env_of(env),
                            jr.make_robot(robot_data))
    params = planner._diff.make_params(jnp.asarray(start), jnp.asarray(goal))
    th0 = j_line(jnp.asarray(start[:, :2]), jnp.asarray(goal[:, :2]),
                 pp["total_time_sec"], m.T)
    cfg = jgn.OptimConfig(engine="standard", reg=0.1, max_iters=10)
    for name, kw in m.RUNS.items():
        r = jax.jit(lambda p, t, s: jms.plan_multistart(
            planner.spec, planner.robot, p, t, s, cfg,
            jax.random.PRNGKey(0), **kw))(params, th0, sdfb)
        got = out[name]
        close(got["th"], r.th, what=name)
        for key in ("contact_free", "k_best", "iters"):
            assert np.array_equal(np_(got[key]), np.asarray(getattr(r, key))
                                  ), (name, key)


def test_plan3d_with_jax_normals_matches_jax():
    out = run("plan3d_example")
    m = module("plan3d_example")
    spec = j_spec(m.SPEC)
    robot = jr.PointRobot3D(sphere_radii=(0.3,))
    cfg = jgn.OptimConfig(engine="standard", reg=0.1, max_iters=40)
    plan = jax.jit(lambda p, t, s: jms.plan_multistart(
        spec, robot, p, t, s, cfg, jax.random.PRNGKey(0),
        restarts=m.RESTARTS, amp=1.5))
    for name, vox, start_p, goal_p, bump in m.worlds():
        params, th0 = m.problem(start_p, goal_p, bump, "cpu", torch.float64)
        sdf = _common.occupancy_sdf(vox, 10.0 / m.N, "cpu", torch.float64)
        r = plan(j_params(params), jnp.asarray(np_(th0)),
                 jnp.asarray(np_(sdf))[None])
        got = out[name]
        close(got["th"], r.th, what=name)
        assert got["contact_free"] == bool(r.contact_free[0]), name
        assert got["iters"] == int(r.iters[0]), name
