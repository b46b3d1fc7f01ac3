"""The planner API of dgpmp2_tpu_torch beyond the 2-D path, against
dgpmp2_tpu: DiffGPMP2Planner from the arm, heading-robot and GP-interpolation
YAMLs (plan, step, error functionals, gradients), GPMP2Planner under GN and
LM, the constrained golden, the original reference's golden GN steps, and
the utils (config, trajectory metrics, angles, matrices).

Float64 on the CPU, B=3, T=16, 32x32 worlds; inputs made with numpy from a
seed.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.planner import DiffGPMP2Planner as JPlanner
from dgpmp2_tpu.planner import GPMP2Planner as JGPMP2Planner
from dgpmp2_tpu.robots import make_robot as j_make_robot
from dgpmp2_tpu.utils import angles as jangles
from dgpmp2_tpu.utils import config as jconfig
from dgpmp2_tpu.utils import mat_utils as jmat
from dgpmp2_tpu.utils import trajectory as jtraj
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner, GPMP2Planner
from dgpmp2_tpu_torch.robots import PointRobot2D, make_robot
from dgpmp2_tpu_torch.utils import angles, mat_utils, trajectory
from dgpmp2_tpu_torch.utils import config as tconfig

from _torch_parity import F64, np_, world

torch.set_num_threads(1)
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
B, T = 3, 16


def yaml_setup(kind):
    """(planner_params, gp, obs, optim, robot_data, env) of one YAML set at
    T=16: the 2-link arm, the heading robot, or the 2-D point robot with GP
    interpolation (3 checks per segment) and velocity limits."""
    files = {"arm": ("gpmp2_arm_params.yaml", "robot_arm.yaml"),
             "xyh": ("gpmp2_xyh_params.yaml", "robot_2d.yaml"),
             "gp_inter_vel": ("gpmp2_2d_params.yaml", "robot_2d.yaml")}[kind]
    env, pp, gp, obs, opt, rd = tconfig.load_params(
        CONFIGS / files[0], CONFIGS / files[1], CONFIGS / "env_2d_params.yaml")
    pp = dict(pp, total_time_step=T)
    if kind == "xyh":
        rd = dict(rd, dof=3)
    if kind == "gp_inter_vel":
        pp = dict(pp, use_gp_inter=True, total_check_step=4 * T,
                  use_vel_limits=True)
        gp = dict(gp, v_x=0.6, v_y=0.7)
    lims = {"x_lims": env["x_lims"], "y_lims": env["y_lims"]}
    return pp, gp, obs, opt, rd, lims


def problem(kind, seed=0):
    """(th0, start, goal, sdf) numpy inputs for one YAML set."""
    imgs, s2, g2 = world(seed, B, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 32))
    rng = np.random.default_rng(seed)
    if kind == "arm":
        start, goal = np.zeros((B, 4)), np.zeros((B, 4))
        start[:, :2] = rng.uniform(-0.4, 0.4, (B, 2)) + (-2.0, 0.0)
        goal[:, :2] = rng.uniform(-0.4, 0.4, (B, 2)) + (1.6, 0.0)
    elif kind == "xyh":
        start, goal = np.zeros((B, 6)), np.zeros((B, 6))
        start[:, :2], goal[:, :2] = s2[:, :2], g2[:, :2]
        start[:, 2] = goal[:, 2] = 0.785
    else:
        start, goal = s2, g2
    dof = start.shape[1] // 2
    alpha = np.linspace(0.0, 1.0, T + 1)[None, :, None]
    pos = start[:, None, :dof] * (1 - alpha) + goal[:, None, :dof] * alpha
    vel = np.broadcast_to(((goal - start)[:, :dof] / 10.0)[:, None], pos.shape)
    return np.concatenate([pos, vel], -1), start, goal, sdf


def planners(kind, optim=None):
    pp, gp, obs, opt, rd, lims = yaml_setup(kind)
    opt = dict(opt, **(optim or {}))
    return (DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(rd),
                             dtype=F64, device="cpu"),
            JPlanner(gp, obs, pp, opt, lims, j_make_robot(rd),
                     dtype=jnp.float64))


KINDS = ["arm", "xyh", "gp_inter_vel"]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_from_the_yamls_matches_jax(kind):
    """Five GN iterations (the YAML's reg and convergence test): 1e-8."""
    planner, j_planner = planners(kind, {"max_iters": 5})
    assert planner.spec == type(planner.spec)(**{
        f: getattr(j_planner.spec, f) for f in planner.spec.__annotations__})
    args = problem(kind)
    got = planner.plan(*args)
    want = j_planner.plan(*args)
    for name in ("th", "err_init", "err_final", "err_per_iter",
                 "err_ext_per_iter"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))


def test_a_five_link_arm_plan_matches_jax():
    """A 5-link arm (D=10, the smallest robot past D=8) from the arm
    YAMLs' weights: five GN iterations, 1e-8."""
    pp, gp, obs, opt, _, lims = yaml_setup("arm")
    rd = {"type": "planar_arm", "link_lengths": [1.0, 0.9, 0.8, 0.6, 0.5],
          "spheres_per_link": 2, "sphere_radius": [0.25]}
    pp = dict(pp, dof=5, state_dim=10)
    gp = dict(gp, Q_c_inv=np.eye(5), q_min=[-2.8] * 5, q_max=[2.8] * 5)
    opt = dict(opt, max_iters=5)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(rd),
                               dtype=F64, device="cpu")
    j_planner = JPlanner(gp, obs, pp, opt, lims, j_make_robot(rd),
                         dtype=jnp.float64)
    assert planner.spec.state_dim == 10 and planner.robot.nlinks == 10
    _, _, _, sdf = problem("arm")
    rng = np.random.default_rng(5)
    start, goal = np.zeros((B, 10)), np.zeros((B, 10))
    start[:, :5] = rng.uniform(-0.4, 0.4, (B, 5)) + (-2.0, 0, 0, 0, 0)
    goal[:, :5] = rng.uniform(-0.4, 0.4, (B, 5)) + (1.6, 0, 0, 0, 0)
    alpha = np.linspace(0.0, 1.0, T + 1)[None, :, None]
    pos = start[:, None, :5] * (1 - alpha) + goal[:, None, :5] * alpha
    vel = np.broadcast_to(((goal - start)[:, :5] / 10.0)[:, None], pos.shape)
    args = (np.concatenate([pos, vel], -1), start, goal, sdf)
    got, want = planner.plan(*args), j_planner.plan(*args)
    for name in ("th", "err_init", "err_final", "err_per_iter"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    assert float(np_(got.err_final).mean()) < float(np_(got.err_init).mean())


def test_a_nine_link_arm_gn_step_matches_jax():
    """A 9-link arm (D=18, past the narrow K-BTD; chip_smoke.py's links,
    3.8 m in all) from the arm YAMLs' weights: one float64 GN step, 1e-8."""
    links = [0.6, 0.5, 0.5, 0.45, 0.4, 0.4, 0.35, 0.3, 0.3]
    pp, gp, obs, opt, _, lims = yaml_setup("arm")
    rd = {"type": "planar_arm", "link_lengths": links, "spheres_per_link": 2,
          "sphere_radius": [0.25]}
    pp = dict(pp, dof=9, state_dim=18)
    gp = dict(gp, Q_c_inv=np.eye(9), q_min=[-2.8] * 9, q_max=[2.8] * 9)
    opt = dict(opt, max_iters=1)
    planner = DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(rd),
                               dtype=F64, device="cpu")
    j_planner = JPlanner(gp, obs, pp, opt, lims, j_make_robot(rd),
                         dtype=jnp.float64)
    assert planner.spec.state_dim == 18 and planner.robot.nlinks == 18
    _, _, _, sdf = problem("arm")
    rng = np.random.default_rng(9)
    start, goal = np.zeros((B, 18)), np.zeros((B, 18))
    start[:, :9] = rng.uniform(-0.4, 0.4, (B, 9))
    goal[:, :9] = rng.uniform(-0.4, 0.4, (B, 9))
    start[:, 0] -= 2.0
    goal[:, 0] += 1.6
    alpha = np.linspace(0.0, 1.0, T + 1)[None, :, None]
    pos = start[:, None, :9] * (1 - alpha) + goal[:, None, :9] * alpha
    vel = np.broadcast_to(((goal - start)[:, :9] / 10.0)[:, None], pos.shape)
    args = (np.concatenate([pos, vel], -1), start, goal, sdf)
    got, want = planner.plan(*args), j_planner.plan(*args)
    for name in ("th", "err_init", "err_final", "err_per_iter"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    assert float(np_(got.err_final).mean()) < float(np_(got.err_init).mean())


@pytest.mark.parametrize("kind", KINDS)
def test_step_and_error_functionals_match_jax(kind):
    planner, j_planner = planners(kind)
    th0, start, goal, sdf = problem(kind, seed=1)
    th = th0 + np.random.default_rng(1).normal(0.0, 0.2, th0.shape)
    got, want = planner.step(th, start, goal, sdf), j_planner.step(
        th, start, goal, sdf)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-8)
    # The JAX side jitted: one compile is faster than eager dispatch.
    for name in ("error_batch", "error_ext_batch", "linear_error",
                 "unweighted_errors_batch"):
        got = getattr(planner, name)(th, start, goal, sdf)
        want = jax.jit(getattr(j_planner, name))(th, start, goal, sdf)
        for a, b in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-10,
                                       atol=1e-10, err_msg=name)


def test_make_params_with_a_workspace_goal_matches_jax():
    pp, gp, obs, opt, _, lims = yaml_setup("arm")
    pp = dict(pp, dof=3, state_dim=6, use_workspace_goal=True)
    gp = dict(gp, Q_c_inv=np.eye(3), q_min=[-2.4] * 3, q_max=[2.4] * 3)
    rd = {"type": "planar_arm", "link_lengths": [1.8, 1.4, 1.2],
          "sphere_radius": [0.25]}
    t = DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(rd), dtype=F64,
                         device="cpu")
    j = JPlanner(gp, obs, pp, opt, lims, j_make_robot(rd), dtype=jnp.float64)
    assert t.spec.self_pairs == j.spec.self_pairs and t.spec.M == j.spec.M
    start = np.zeros((B, 6))
    target = np.random.default_rng(2).uniform(1.0, 3.0, (B, 2))
    got = t.make_params(start, start, workspace_goal=target)
    want = j.make_params(start, start, workspace_goal=target)
    for name in ("wg_inv", "p_goal", "self_inv", "self_eps", "jl_inv",
                 "q_min", "q_max"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-14,
                                   err_msg=name)


def test_err_ext_gradient_through_an_arm_plan_matches_jax_grad():
    """d err_ext / d (obscov_inv_traj, eps_traj) through a 3-iteration plan
    of the 2-link arm (self-collision, joint limits): 1e-6 relative."""
    planner, j_planner = planners("arm", {"max_iters": 3, "tol_delta": 0.0})
    th0, start, goal, sdf = problem("arm", seed=3)
    spec = planner.spec
    tn, l = spec.num_traj_states, spec.nlinks
    rng = np.random.default_rng(3)
    obs = np.eye(l) * rng.uniform(50.0, 400.0, (B, tn, 1, l))
    eps = rng.uniform(0.1, 0.4, (B, tn, l))

    def j_loss(o, e):
        r = j_planner.plan(th0, start, goal, sdf, obscov_inv_traj=o,
                           eps_traj=e)
        return jnp.sum(r.err_ext_per_iter)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(obs),
                                            jnp.asarray(eps))
    o = torch.tensor(obs, requires_grad=True)
    e = torch.tensor(eps, requires_grad=True)
    r = planner.plan(th0, start, goal, sdf, obscov_inv_traj=o, eps_traj=e)
    torch.sum(r.err_ext_per_iter).backward()
    for got, ref in zip((o.grad, e.grad), want):
        ref = np_(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(np_(got), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("kind,method", [("gp_inter_vel", "gauss_newton"),
                                         ("gp_inter_vel", "lm"),
                                         ("arm", "lm")])
def test_gpmp2_planner_matches_jax(kind, method):
    """GPMP2Planner (float64): step and error on one problem, plan of one
    problem, and plan_batch with per-problem LM lambdas and the host
    convergence exit."""
    pp, gp, obs, _, rd, lims = yaml_setup(kind)
    t = GPMP2Planner(gp, obs, pp, lims, make_robot(rd), device="cpu")
    j = JGPMP2Planner(gp, obs, pp, lims, j_make_robot(rd))
    assert t.dtype == F64 and t.spec.M == j.spec.M
    th0, start, goal, sdf = problem(kind, seed=4)
    optim = {"method": method, "max_iters": 8, "tol_delta": 1e-3,
             "reg": 0.05, "plan_time": "inf"}
    for a, b in zip(t.step(th0[0], start[0], goal[0], sdf[0], optim),
                    j.step(th0[0], start[0], goal[0], sdf[0], optim)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(t.error(th0[1], start[1], goal[1], sdf[1]),
                               j.error(th0[1], start[1], goal[1], sdf[1]),
                               rtol=1e-10)
    got = t.plan_batch(start, goal, th0, sdf, optim)
    want = j.plan_batch(start, goal, th0, sdf, optim)
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), rtol=1e-8,
                               atol=1e-8)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert len(got[3]) == len(want[3])
    np.testing.assert_allclose(np.stack(got[3]), np.stack(want[3]),
                               rtol=1e-9)
    np.testing.assert_array_equal(got[4], want[4])
    one, one_j = (p.plan(start[2], goal[2], th0[2], sdf[2], optim)
                  for p in (t, j))
    np.testing.assert_allclose(np_(one[0]), np_(one_j[0]), rtol=1e-8,
                               atol=1e-8)
    assert one[4] == one_j[4] and len(one[3]) == len(one_j[3])


def test_plan_batch_stops_at_its_time_budget_like_jax():
    pp, gp, obs, _, rd, lims = yaml_setup("gp_inter_vel")
    th0, start, goal, sdf = problem("gp_inter_vel", seed=5)
    optim = {"method": "gauss_newton", "max_iters": 50, "tol_delta": 0.0,
             "plan_time": 0.0}
    got = GPMP2Planner(gp, obs, pp, lims, make_robot(rd),
                       device="cpu").plan_batch(start, goal, th0, sdf, optim)
    want = JGPMP2Planner(gp, obs, pp, lims, j_make_robot(rd)).plan_batch(
        start, goal, th0, sdf, optim)
    assert len(got[3]) == len(want[3]) == 1
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("case", ["arm2", "arm3_task", "xyh",
                                  "gp_inter_vel"])
def test_constrained_golden_replays(case):
    """The constrained float64 golden the JAX package wrote (the check that
    chip_smoke.py repeats on the card with the kernels): 1e-8 relative."""
    g = dict(np.load(chip_smoke.GOLDEN_EXT))
    out = chip_smoke.golden_ext_plan(torch.device("cpu"), case, g)
    errs = chip_smoke.golden_errors(out, g, f"{case}_")
    assert all(v <= 1e-8 for v in errs.values()), errs
    assert os.path.getsize(chip_smoke.GOLDEN_EXT) < 200_000


# --- the original reference's golden GN steps (tests/test_golden_parity.py) -

GOLDEN_REF = Path(__file__).resolve().parent / "goldens" / "golden_ref_step.npz"


@pytest.fixture(scope="module")
def golden_ref():
    """The golden and a float64 planner of its config, under the reference
    out-of-bounds lookup semantics (restored afterwards)."""
    g = np.load(GOLDEN_REF, allow_pickle=False)
    planner = DiffGPMP2Planner(
        {"Q_c_inv": g["qc_inv"], "K_s": g["k_s"], "K_g": g["k_g"]},
        {"cost_sigma": float(g["cost_sigma"]),
         "epsilon_dist": float(g["epsilon_dist"])},
        {"dof": 2, "state_dim": 4,
         "total_time_sec": float(g["total_time_sec"]),
         "total_time_step": int(g["total_time_step"])},
        {"method": "gauss_newton", "reg": float(g["reg"]), "max_iters": 100,
         "tol_err": 1e-3, "tol_delta": 1e-4},
        {"x_lims": g["x_lims"].tolist(), "y_lims": g["y_lims"].tolist()},
        PointRobot2D(sphere_radii=(float(g["sphere_radius"]),)), dtype=F64,
        device="cpu")
    tsdf.set_oob_mode("reference")
    yield g, planner
    tsdf.set_oob_mode("intended")


@pytest.mark.parametrize("env", ["1", "5", "12"])
def test_step_matches_the_reference_golden(golden_ref, env):
    """12 open-loop GN steps from the reference's inputs: th, dtheta, err and
    err_ext within 1e-5 of the original PyTorch reference at every step."""
    g, planner = golden_ref
    sdf = g[f"sdf_{env}"][None]
    start, goal = g[f"start_{env}"], g[f"goal_{env}"]
    th_ref, dth_ref = g[f"th_{env}"], g[f"dtheta_{env}"]
    th = torch.tensor(th_ref[0])
    assert dth_ref.shape[0] >= 10
    for i in range(dth_ref.shape[0]):
        dth, err, err_ext, _ = planner.step(th, start, goal, sdf)
        for name, a, ref in (("dtheta", dth, dth_ref[i]),
                             ("err", err, g[f"err_{env}"][i]),
                             ("err_ext", err_ext, g[f"err_ext_{env}"][i])):
            np.testing.assert_allclose(np_(a).reshape(np.shape(ref)), ref,
                                       atol=1e-5, rtol=0,
                                       err_msg=f"env {env} iter {i}: {name}")
        th = th + dth
        np.testing.assert_allclose(np_(th), th_ref[i + 1], atol=1e-5, rtol=0,
                                   err_msg=f"env {env} iter {i}: th")


@pytest.mark.parametrize("env", ["1", "5", "12"])
def test_gradient_matches_the_reference_golden(golden_ref, env):
    """d(Σ th_K²)/d(th_0, sdf) through K unrolled steps, by torch.autograd,
    against the original reference's autograd: 1e-5 of the largest entry."""
    g, planner = golden_ref
    th = torch.tensor(g[f"th_{env}"][0], requires_grad=True)
    sdf = torch.tensor(g[f"sdf_{env}"][None], requires_grad=True)
    x = th
    for _ in range(int(g["grad_iters"])):
        x = x + planner.step(x, g[f"start_{env}"], g[f"goal_{env}"], sdf)[0]
    torch.sum(x**2).backward()
    for got, ref in ((th.grad, g[f"grad_th0_{env}"]),
                     (sdf.grad[0], g[f"grad_sdf_{env}"][0])):
        np.testing.assert_allclose(np_(got), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# --- utils -------------------------------------------------------------------


def test_config_helpers_match_jax():
    files = [CONFIGS / f for f in ("gpmp2_2d_params.yaml", "robot_2d.yaml",
                                   "env_2d_params.yaml", "learn_params.yaml")]
    got, want = (tconfig.load_params_learn(*files),
                 jconfig.load_params_learn(*files))
    assert got[-1] == want[-1] and got[1] == want[1]
    for opt in ({"plan_time": "inf"}, {"plan_time": 2}, {"plan_time": "0.5"},
                {}):
        assert tconfig.plan_time_budget(opt) == jconfig.plan_time_budget(opt)
    pp, gp, obs, opt, rd, lims = yaml_setup("arm")
    planner = DiffGPMP2Planner(gp, obs, pp, opt, lims, make_robot(rd),
                               learn_params=got[-1], device="cpu")
    assert planner.dynamics_mode == "diag_identity"
    assert planner.learn_params is got[-1]
    for check in (1, 8, 9, 48):
        p = dict(pp, use_gp_inter=True, total_check_step=check)
        assert (tconfig.spec_from_params(p, lims, make_robot(rd)).num_inter
                == jconfig.spec_from_params(p, lims,
                                            j_make_robot(rd)).num_inter)


def test_trajectory_metrics_match_jax():
    rng = np.random.default_rng(6)
    traj = rng.standard_normal((2, 3, T + 1, 4))
    for a, b in zip(trajectory.smoothness_metrics(torch.tensor(traj), 10.0, T),
                    jtraj.smoothness_metrics(jnp.asarray(traj), 10.0, T)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12)
    obs_err = np.maximum(rng.normal(0.0, 0.3, (3, T + 1, 2)), 0.0)
    for eps in (None, 0.2, np.full((3, T + 1, 2), 0.1)):
        got = trajectory.collision_metrics(torch.tensor(obs_err), 10.0, T, eps)
        want = jtraj.collision_metrics(jnp.asarray(obs_err), 10.0, T, eps)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=1e-12,
                                       err_msg=k)
    path = rng.standard_normal((3, 9, 2))
    np.testing.assert_allclose(
        np_(trajectory.path_to_traj_avg_vel(torch.tensor(path), 4.0)),
        np_(jtraj.path_to_traj_avg_vel(jnp.asarray(path), 4.0)), rtol=1e-12)


def test_angles_and_mat_utils_match_jax():
    ang = np.concatenate([np.linspace(-20.0, 20.0, 41),
                          [np.pi, -np.pi, 0.0, 2 * np.pi]])
    for name in ("normalize_angle_positive", "normalize_angle"):
        np.testing.assert_allclose(
            np_(getattr(angles, name)(torch.tensor(ang))),
            np_(getattr(jangles, name)(jnp.asarray(ang))), atol=1e-12,
            err_msg=name)
    np.testing.assert_allclose(
        np_(angles.angular_distance(torch.tensor(ang),
                                    torch.tensor(ang[::-1].copy()))),
        np_(jangles.angular_distance(jnp.asarray(ang), jnp.asarray(ang[::-1]))),
        atol=1e-12)
    assert float(angles.normalize_angle(3 * np.pi / 2)) == pytest.approx(
        -np.pi / 2)
    np.testing.assert_array_equal(
        np_(mat_utils.isotropic_matrix(2.5, 3, F64, "cpu")),
        np_(jmat.isotropic_matrix(2.5, 3, jnp.float64)))
    sig = torch.tensor(0.3, dtype=F64, requires_grad=True)
    mat_utils.isotropic_matrix(sig, 4, F64, "cpu").sum().backward()
    assert float(sig.grad) == 4.0
