"""The constrained factor family of dgpmp2_tpu_torch against dgpmp2_tpu:
GP interpolation, nonholonomic, velocity-limit, self-collision, joint-limit
and workspace-goal factors, alone and combined, through residuals,
assembly, errors, the stacked residual vector and the unweighted errors.

Float64 on the CPU, B=3, T=12, 32x32 worlds; inputs made with numpy from a
seed.  Factor functions: 1e-12; graph functions: 1e-10 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import factors as jf
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch import robots as tr
from dgpmp2_tpu_torch.core import factors as tf
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.ops import sdf as tsdf

from _torch_parity import F64, np_, params_arrays, world

torch.set_num_threads(1)
TOL = 1e-12
GTOL = 1e-10
B, T = 3, 12
# The JAX side jitted (spec and robot static): one compile per case is
# faster than eager dispatch of every primitive.
J_EVAL = jax.jit(jg.eval_residuals, static_argnums=(0, 1))
J_ASM = jax.jit(jg.assemble_from_residuals, static_argnums=(0,))
J_ERR = jax.jit(jg.error_from_residuals, static_argnums=(0,))
J_GERR = jax.jit(jg.graph_error, static_argnums=(0, 1))
J_LIN = jax.jit(jg.linear_error, static_argnums=(0, 1))
J_UNW = jax.jit(jg.unweighted_errors, static_argnums=(0, 1))

ROBOTS = {
    "point": ("PointRobot2D", {}),
    "xyh": ("PointRobotXYH", {}),
    "point3d": ("PointRobot3D", {}),
    "arm2": ("PlanarArm2Link", dict(link_lengths=(2.5, 2.0),
                                    spheres_per_link=3,
                                    sphere_radii=(0.25,) * 6)),
    "arm3": ("PlanarArmNLink", dict(link_lengths=(1.8, 1.4, 1.2),
                                    spheres_per_link=2,
                                    sphere_radii=(0.25,))),
}
# case -> (robot, GraphSpec options); every option alone, then the
# combinations the repo's configs and examples use, then all of them.
CASES = {
    "non_holonomic": ("xyh", dict(non_holonomic=True)),
    "vel_limits": ("point", dict(use_vel_limits=True)),
    "gp_inter": ("point", dict(use_gp_inter=True, num_inter=3)),
    "self_collision": ("arm2", dict(use_self_collision=True)),
    "joint_limits": ("arm2", dict(use_joint_limits=True)),
    "workspace_goal": ("arm3", dict(use_workspace_goal=True)),
    "arm_yaml": ("arm2", dict(use_self_collision=True,
                              use_joint_limits=True)),
    "arm3_task": ("arm3", dict(use_self_collision=True, use_joint_limits=True,
                               use_workspace_goal=True)),
    "gp_inter_vel": ("point", dict(use_gp_inter=True, num_inter=3,
                                   use_vel_limits=True)),
    "gp_inter_arm": ("arm2", dict(use_gp_inter=True, num_inter=2,
                                  use_self_collision=True)),
    "vel_limits_3d": ("point3d", dict(use_vel_limits=True,
                                      z_lims=(-5.0, 5.0))),
    "all": ("arm3", dict(non_holonomic=True, use_vel_limits=True,
                         use_gp_inter=True, num_inter=2,
                         use_self_collision=True, use_joint_limits=True,
                         use_workspace_goal=True)),
}


def _robots(name):
    cls, kw = ROBOTS[name]
    return getattr(jr, cls)(**kw), getattr(tr, cls)(**kw)


def build(case):
    """The same float64 problem in both packages, each from its own
    default_params: (spec, robot, params, th, sdf) for JAX, then torch."""
    rname, opts = CASES[case]
    j_robot, t_robot = _robots(rname)
    dof, d = t_robot.dofs, t_robot.state_dim
    rng = np.random.default_rng(sorted(CASES).index(case))
    spec_kw = dict(dof=dof, state_dim=d, total_time_step=T,
                   nlinks=t_robot.nlinks, **opts)
    if opts.get("use_self_collision"):
        spec_kw["self_pairs"] = jr.self_collision_pairs(j_robot)
    n = 16 if rname == "point3d" else 32
    if rname == "point3d":
        sdf_np = np.asarray(jsdf.sdf_from_occupancy_3d(
            jnp.asarray(np.pad(np.ones((B, 8, 8, 8)), 4, constant_values=0)[
                4:-4]), res=10.0 / n))
    else:
        imgs, _, _ = world(sorted(CASES).index(case), B, n)
        sdf_np = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs),
                                                    res=10.0 / n))
    # Arms: joint angles anywhere (folds trigger self-collision, limits
    # bind); point robots: a noisy path across the world.
    if rname.startswith("arm"):
        th = np.concatenate([rng.uniform(-3.0, 3.0, (B, T + 1, dof)),
                             rng.normal(0.0, 0.8, (B, T + 1, dof))], -1)
    else:
        line = np.linspace(-4.0, 4.0, T + 1)[None, :, None]
        th = np.concatenate([line + rng.normal(0.0, 0.6, (B, T + 1, dof)),
                             rng.normal(0.0, 1.0, (B, T + 1, dof))], -1)
    start, goal = th[:, 0] + 0.1, th[:, -1] - 0.1
    kw = dict(qc_inv=np.eye(dof), cost_sigma=0.2, epsilon_dist=0.6,
              k_s=0.01, k_g=0.05, k_d=0.1, k_v=0.2,
              v_x=[0.5 + 0.1 * i for i in range(dof)], k_self=0.05,
              eps_self=0.1, k_jl=0.1, q_min=[-1.5] * dof, q_max=[1.2] * dof,
              k_wg=0.1, workspace_goal=rng.uniform(-2.0, 2.0, (B, 2)))
    spec_j, spec_t = jg.GraphSpec(**spec_kw), tg.GraphSpec(**spec_kw)
    p_j = jg.default_params(spec_j, j_robot, jnp.asarray(start),
                            jnp.asarray(goal), dtype=jnp.float64, **kw)
    p_t = tg.default_params(spec_t, t_robot, torch.tensor(start),
                            torch.tensor(goal), dtype=F64, **kw)
    return ((spec_j, j_robot, p_j, jnp.asarray(th), jnp.asarray(sdf_np)),
            (spec_t, t_robot, p_t, torch.tensor(th), torch.tensor(sdf_np)))


_CACHE = {}


@pytest.fixture
def problem(request):
    case = request.param
    if case not in _CACHE:
        pj, pt = build(case)
        _CACHE[case] = (pj, pt, J_EVAL(*pj), tg.eval_residuals(*pt))
    return _CACHE[case]


def close(got, want, tol=GTOL, msg=""):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def all_cases(fn):
    return pytest.mark.parametrize("problem", sorted(CASES),
                                   indirect=True)(fn)


@all_cases
def test_eval_residuals_match_jax(problem):
    (spec_j, *_), (spec_t, *_), r_j, r_t = problem
    assert spec_t.M == spec_j.M and spec_t.N == spec_j.N
    for f in dataclasses.fields(r_t):
        a, b = getattr(r_t, f.name), getattr(r_j, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            close(a, b, msg=f.name)
    # The hinges of every enabled factor are active somewhere.
    for name in ("r_vel", "r_self", "r_jl", "r_obsi"):
        a = getattr(r_t, name)
        if a is not None:
            assert bool((a > 0).any()), name


@all_cases
def test_assembly_matches_jax(problem, monkeypatch):
    """Both forms of the unary terms: broadcast products, and the batched
    matrix products that large robots take (BROADCAST_MAX forced to 0)."""
    (spec_j, _, p_j, *_), (spec_t, _, p_t, *_), r_j, r_t = problem
    want = J_ASM(spec_j, p_j, r_j)
    static = tg.assemble_static(spec_t, p_t, F64)
    off0 = static.off.clone()
    got = [tg.assemble_from_residuals(spec_t, p_t, r_t),
           tg.assemble_from_residuals(spec_t, p_t, r_t, static=static)]
    monkeypatch.setattr(tg, "BROADCAST_MAX", 0)
    got.append(tg.assemble_from_residuals(spec_t, p_t, r_t, static=static))
    for sys_ in got:
        for name, a, b in zip(("diag", "off", "rhs"), sys_, want):
            close(a, b, msg=name)
    # The GP-interpolation couplings go into a new off tensor: the static
    # blocks a plan loop reuses stay as they were.
    assert torch.equal(static.off, off0)


@all_cases
def test_errors_match_jax(problem):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t), r_j, r_t = problem
    close(tg.error_from_residuals(spec_t, p_t, r_t),
          J_ERR(spec_j, p_j, r_j))
    q2, o2 = 2.0 * p_j.q_inv, 3.0 * p_j.obs_inv
    close(tg.graph_error(spec_t, robot_t, p_t, th_t, sdf_t,
                         q_inv=torch.tensor(np_(q2)),
                         obs_inv=torch.tensor(np_(o2))),
          J_GERR(spec_j, robot_j, p_j, th_j, sdf_j, q2, o2))


@all_cases
def test_linear_error_matches_jax(problem):
    pj, pt, *_ = problem
    got, want = tg.linear_error(*pt), J_LIN(*pj)
    assert got.shape == (B, pt[0].M)
    close(got, want)


@all_cases
def test_unweighted_errors_match_jax(problem):
    pj, pt, r_j, r_t = problem
    for a, b in zip(tg.unweighted_errors(*pt), J_UNW(*pj)):
        close(a, b)
    for a, b in zip(tg.unweighted_errors_from_residuals(r_t),
                    jg.unweighted_errors_from_residuals(r_j)):
        close(a, b)


@all_cases
def test_default_params_match_jax_and_convert(problem):
    (_, _, p_j, *_), (_, _, p_t, *_), *_ = problem
    conv = convert.graph_params_from_numpy(params_arrays(p_j), "cpu", F64)
    for f in dataclasses.fields(p_t):
        a, b, c = (getattr(p, f.name) for p in (p_t, p_j, conv))
        assert (a is None) == (b is None) == (c is None), f.name
        if a is not None:
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-14,
                                       err_msg=f.name)
            assert torch.equal(c, a.contiguous()), f.name


def test_graph_params_from_numpy_carries_every_optional_field():
    _, (spec_t, _, p_t, *_) = build("all")
    arrays = {f.name: np_(getattr(p_t, f.name))
              for f in dataclasses.fields(p_t)}
    assert all(v is not None for v in arrays.values())
    got = convert.graph_params_from_numpy(arrays, "cpu", torch.float32)
    for name, a in arrays.items():
        t = getattr(got, name)
        assert t.dtype == torch.float32 and t.shape == a.shape, name
        np.testing.assert_allclose(np_(t), a, rtol=1e-6, err_msg=name)


def test_graph_spec_with_every_option_constructs():
    kw = dict(non_holonomic=True, use_vel_limits=True, use_gp_inter=True,
              use_self_collision=True, use_joint_limits=True,
              use_workspace_goal=True, self_pairs=((0, 2), (1, 3)),
              num_inter=4, nlinks=4)
    spec_t, spec_j = tg.GraphSpec(**kw), jg.GraphSpec(**kw)
    assert spec_t.M == spec_j.M and spec_t.num_self_pairs == 2
    assert [f.name for f in dataclasses.fields(spec_t)] == [
        f.name for f in dataclasses.fields(spec_j)]


def test_velocity_limit_count_must_match_dof_like_jax():
    spec_kw = dict(use_vel_limits=True, total_time_step=4)
    args = (np.zeros((1, 4)), np.zeros((1, 4)))
    kw = dict(qc_inv=np.eye(2), cost_sigma=0.1, epsilon_dist=0.2, k_s=0.1,
              k_g=0.1, k_v=0.1, v_x=[1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="velocity limits have 3"):
        tg.default_params(tg.GraphSpec(**spec_kw), tr.PointRobot2D(),
                          *map(torch.tensor, args), **kw)
    with pytest.raises(ValueError, match="velocity limits have 3"):
        jg.default_params(jg.GraphSpec(**spec_kw), jr.PointRobot2D(),
                          *map(jnp.asarray, args), **kw)
    # Scalars v_x, v_y give the two per-axis limits.
    p = tg.default_params(tg.GraphSpec(**spec_kw), tr.PointRobot2D(),
                          *map(torch.tensor, args),
                          **dict(kw, v_x=0.3, v_y=0.4), dtype=F64)
    assert p.v_lim.shape == (1, 5, 2) and p.v_lim[0, 0].tolist() == [0.3, 0.4]


# --- the factor functions ---------------------------------------------------


@pytest.mark.parametrize("dof,dt,nip", [(2, 0.1, 3), (3, 0.25, 1),
                                        (2, 1.0, 5)])
def test_gp_interp_coeffs_and_interpolate(dof, dt, nip):
    lam_t, psi_t = tf.gp_interp_coeffs(dof, dt, nip, F64, "cpu")
    lam_j, psi_j = jf.gp_interp_coeffs(dof, dt, nip, jnp.float64)
    np.testing.assert_allclose(np_(lam_t), np_(lam_j), atol=TOL)
    np.testing.assert_allclose(np_(psi_t), np_(psi_j), atol=TOL)
    assert tf.gp_interp_coeffs(dof, dt, nip, F64, "cpu")[0] is lam_t
    th = np.random.default_rng(nip).standard_normal((2, 7, 2 * dof))
    np.testing.assert_allclose(
        np_(tf.gp_interpolate(torch.tensor(th), lam_t, psi_t)),
        np_(jf.gp_interpolate(jnp.asarray(th), lam_j, psi_j)), atol=TOL)


def test_nonholonomic_residual():
    th = np.random.default_rng(0).standard_normal((3, 9, 6))
    for a, b in zip(tf.nonholonomic_residual(torch.tensor(th)),
                    jf.nonholonomic_residual(jnp.asarray(th))):
        np.testing.assert_allclose(np_(a), np_(b), atol=TOL)


def test_velocity_limit_residual_at_its_boundary():
    """|v| == v_lim exactly: the hinge is active (>=) with r = 0 and the
    -sign(v) Jacobian row, in both packages."""
    rng = np.random.default_rng(1)
    th = rng.standard_normal((2, 6, 4))
    v_lim = np.abs(rng.standard_normal((2, 6, 2))) * 0.8
    th[0, 2, 2] = v_lim[0, 2, 0]
    th[1, 3, 3] = -v_lim[1, 3, 1]
    r_t, h_t = tf.velocity_limit_residual(torch.tensor(th),
                                          torch.tensor(v_lim), 2)
    r_j, h_j = jf.velocity_limit_residual(jnp.asarray(th),
                                          jnp.asarray(v_lim), 2)
    np.testing.assert_allclose(np_(r_t), np_(r_j), atol=TOL)
    np.testing.assert_allclose(np_(h_t), np_(h_j), atol=TOL)
    assert float(h_t[0, 2, 0, 2]) == -1.0 and float(h_t[1, 3, 1, 3]) == 1.0
    assert float(r_t[0, 2, 0]) == 0.0


def test_joint_limit_residual_at_its_boundaries():
    rng = np.random.default_rng(2)
    th = rng.uniform(-2.0, 2.0, (2, 6, 6))
    q_min = np.full((2, 6, 3), -1.0)
    q_max = np.full((2, 6, 3), 1.2)
    th[0, 1, 0], th[1, 4, 2] = 1.2, -1.0
    r_t, h_t = tf.joint_limit_residual(torch.tensor(th), torch.tensor(q_min),
                                       torch.tensor(q_max), 3)
    r_j, h_j = jf.joint_limit_residual(jnp.asarray(th), jnp.asarray(q_min),
                                       jnp.asarray(q_max), 3)
    np.testing.assert_allclose(np_(r_t), np_(r_j), atol=TOL)
    np.testing.assert_allclose(np_(h_t), np_(h_j), atol=TOL)
    assert float(h_t[0, 1, 0, 0]) == -1.0 and float(h_t[1, 4, 2, 2]) == 1.0


def test_self_collision_and_workspace_goal_residuals():
    j_arm, t_arm = _robots("arm3")
    rng = np.random.default_rng(3)
    th = rng.uniform(-3.0, 3.0, (4, 5, 6))
    c_t, jac_t = t_arm.fk(torch.tensor(th))
    c_j, jac_j = jax.jit(j_arm.fk)(jnp.asarray(th))
    pairs = np.asarray(jr.self_collision_pairs(j_arm))
    eps = rng.uniform(0.0, 0.5, (4, 5, len(pairs)))
    radii = np.asarray(t_arm.sphere_radii)
    got = tf.self_collision_residual(
        c_t, jac_t, torch.tensor(radii), torch.tensor(pairs[:, 0]),
        torch.tensor(pairs[:, 1]), torch.tensor(eps))
    want = jax.jit(jf.self_collision_residual)(c_j, jac_j, jnp.asarray(radii),
                                      jnp.asarray(pairs[:, 0]),
                                      jnp.asarray(pairs[:, 1]),
                                      jnp.asarray(eps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), atol=TOL)
    assert bool((got[0] > 0).any()) and bool((got[0] == 0).any())
    p_goal = rng.standard_normal((4, 2))
    for a, b in zip(
            tf.workspace_goal_residual(c_t[:, -1], jac_t[:, -1],
                                       torch.tensor(p_goal)),
            jf.workspace_goal_residual(c_j[:, -1], jac_j[:, -1],
                                       jnp.asarray(p_goal))):
        np.testing.assert_allclose(np_(a), np_(b), atol=TOL)


def test_pair_index_is_made_once_per_device():
    pairs = ((0, 3), (1, 4))
    a = tg.pair_index(pairs, torch.device("cpu"))
    assert a is tg.pair_index(pairs, torch.device("cpu"))
    assert a[0].tolist() == [0, 1] and a[1].tolist() == [3, 4]
    assert tg.pair_index((), torch.device("cpu"))[0].shape == (0,)


def test_lookup_is_fused_under_gp_inter(monkeypatch):
    """One SDF lookup per residual evaluation covers the support and the
    interpolated states."""
    _, pt = build("gp_inter_arm")
    calls = []
    real = tsdf.lookup_nd

    def counting(sdf, pts, *a):
        calls.append(tuple(pts.shape))
        return real(sdf, pts, *a)

    monkeypatch.setattr(tsdf, "lookup_nd", counting)
    tg.eval_residuals(*pt)
    spec = pt[0]
    assert calls == [(B, (T + 1) * spec.nlinks
                      + T * spec.num_inter * spec.nlinks, 2)]
