"""dgpmp2_tpu_torch.examples on the CPU in float64: the classic and
differentiable 2-D planners, replanning and serving (the robots, factors,
RRT*, multistart and 3-D examples are in ``test_torch_examples_robots.py``,
the data and learning ones in ``test_torch_examples_data.py``).

Every example runs once through its ``main`` (``--device cpu --dtype
float64``, its default sizes) and must return finite numbers and lower each
problem's error; then its results are held against the JAX package's
functions fed the same numpy inputs (the SDFs the port built, the same
seeds), under ``tests/conftest.py``'s CPU float64: trajectories, errors and
gradients within 1e-8, iteration counts exact.  The JAX example programs
themselves are not run: they execute when imported and pin their platform.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu import serve as jserve
from dgpmp2_tpu.planner import DiffGPMP2Planner as JDiffPlanner
from dgpmp2_tpu.planner import GPMP2Planner as JGPMP2Planner
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_line
from dgpmp2_tpu_torch.examples import EXAMPLES, _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner as TDiffPlanner
from dgpmp2_tpu_torch.robots import make_robot as t_make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj as t_line

from tests._torch_examples import (ROOT, TOL, box_sdf, check_plans, close,
                                   env_of, j_configs, j_diff_planner,
                                   j_line_of, module, np_, run)

torch.set_num_threads(1)
NAMES = ("gpmp2_2d_example", "gpmp2_2d_step_example",
         "diff_gpmp2_2d_example", "diff_gpmp2_2d_step_example",
         "diff_gpmp2_2d_batch_example", "diff_gpmp2_2d_batch_step_example",
         "replanning_example", "serving_example")


@pytest.mark.parametrize("name", NAMES)
def test_example_plans_on_the_cpu(name):
    check_plans(name)


def test_every_example_imports_without_jax_or_matplotlib():
    """No module of the examples reaches JAX, nor matplotlib when imported
    (matplotlib only inside a ``--plot``)."""
    names = ("_common",) + EXAMPLES
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['matplotlib'] = None; import importlib; "
            + "; ".join(f"importlib.import_module("
                        f"'dgpmp2_tpu_torch.examples.{n}')" for n in names))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_every_jax_example_has_a_counterpart():
    jax_names = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                       if p.stem != "_common")
    assert sorted(EXAMPLES) == jax_names


def test_gpmp2_2d_gn_and_lm_match_jax():
    out = run("gpmp2_2d_example")
    env, pp, gp, obs, _, robot_data = j_configs()
    planner = JGPMP2Planner(gp, obs, pp, env_of(env),
                            jr.make_robot(robot_data))
    m = module("gpmp2_2d_example")
    start, goal = np.asarray(m.START), np.asarray(m.GOAL)
    th0 = j_line_of(start[None], goal[None], pp)[0]
    for method in ("gauss_newton", "lm"):
        th, e0, ef, _, iters, _ = planner.plan(
            start, goal, th0, box_sdf(), dict(m.OPTIM, method=method))
        got = out[method]
        assert got["iters"] == iters, method
        close(got["th"], th, what=method)
        close([got["err_init"], got["err_final"]], [e0, ef], what=method)


def test_diff_2d_gradient_through_the_plan_matches_jax():
    out = run("diff_gpmp2_2d_example")
    planner, pp = j_diff_planner()
    m = module("diff_gpmp2_2d_example")
    start, goal = np.asarray([m.START]), np.asarray([m.GOAL])
    th0 = j_line_of(start, goal, pp)
    sdf = box_sdf()[None]
    r = planner.plan(th0, start, goal, sdf)
    close(out["th"], r.th)
    assert np.array_equal(np_(out["iters"]), np.asarray(r.iters))
    cot = jnp.asarray(m.cotangent(r.th.shape))
    grad = jax.grad(lambda t: jnp.sum(
        planner.plan(t, start, goal, sdf).th * cot))(th0)
    want = np.asarray(grad)
    np.testing.assert_allclose(np_(out["grad"]), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_diff_2d_batch_matches_jax():
    out = run("diff_gpmp2_2d_batch_example")
    planner, pp = j_diff_planner()
    m = module("diff_gpmp2_2d_batch_example")
    start, goal = m.endpoints(m.B, 0, 3.0, 4.5)
    sdf = np.broadcast_to(box_sdf(), (m.B, 128, 128))
    r = planner.plan(j_line_of(start, goal, pp), start, goal, sdf)
    close(out["th"], r.th)
    close(out["err_final"], r.err_final)
    close(out["err_init"], r.err_init)
    assert np.array_equal(np_(out["iters"]), np.asarray(r.iters))


def test_replanning_matches_jax():
    out = run("replanning_example")
    m = module("replanning_example")
    env, pp, gp, obs, _, robot_data = j_configs()
    pp = dict(pp, total_time_step=m.T)
    planner = JGPMP2Planner(gp, obs, pp, env_of(env),
                            jr.make_robot(robot_data))
    start, goal = m.endpoints()
    th0 = j_line(jnp.asarray(start[:, :2]), jnp.asarray(goal[:, :2]),
                 pp["total_time_sec"], m.T)
    sdfb = {}
    for shift in (0, m.SHIFT_PX):
        sdf = np_(_common.occupancy_sdf(m.box_image(shift), 10.0 / m.IMSIZE,
                                        "cpu", torch.float64))
        sdfb[shift] = np.broadcast_to(sdf, (m.B,) + sdf.shape)
    prev = None
    for name, shift in (("initial", 0), ("cold", m.SHIFT_PX),
                        ("warm", m.SHIFT_PX)):
        seed = prev if name == "warm" else th0
        th, e0, ef, _, iters, _ = planner.plan_batch(start, goal, seed,
                                                     sdfb[shift], m.OPTIM)
        if name == "initial":
            prev = th
        got = out[name]
        assert np.array_equal(np_(got["iters"]), np.asarray(iters)), name
        close(got["th"], th, what=name)
        close(got["err_init"], e0, what=name)
        close(got["err_final"], ef, what=name)


def test_served_plans_equal_a_direct_plan_and_jax():
    """Each response is the port's batched ``plan`` of its dispatch's rows
    bit for bit, and JAX's ``plan_batch_sync`` of them within 1e-8."""
    out = run("serving_example")
    m = module("serving_example")
    env, pp, gp, obs, opt, robot_data = j_configs()
    pp = dict(pp, total_time_step=m.T)
    tplanner = TDiffPlanner(gp, obs, pp, opt, env_of(env),
                            t_make_robot(robot_data), dtype=torch.float64,
                            device="cpu")
    jplanner = JDiffPlanner(gp, obs, pp, opt, env_of(env),
                            jr.make_robot(robot_data), dtype=jnp.float64)
    jsvc = jserve.PlanningService(jplanner, batch_size=m.BATCH)
    reqs = out["requests"]
    for k in range(0, m.CLIENTS, m.BATCH):
        rows = reqs[k:k + m.BATCH]
        start = np.stack([r.start for r in rows])
        goal = np.stack([r.goal for r in rows])
        th0 = t_line(torch.tensor(start[:, :2]), torch.tensor(goal[:, :2]),
                     pp["total_time_sec"], m.T)
        with torch.no_grad():
            direct = tplanner.plan(th0, start, goal,
                                   np.stack([r.sdf for r in rows]))
        assert np.array_equal(out["th"][k:k + m.BATCH], np_(direct.th))
        want = jsvc.plan_batch_sync([jserve.PlanRequest(
            start=r.start, goal=r.goal, sdf=r.sdf) for r in rows])
        close(out["th"][k:k + m.BATCH], np.stack([w.th for w in want]))
        close(out["err_final"][k:k + m.BATCH],
              [w.err_final for w in want])
