"""The port's df32 engine against the JAX package's, on the golden problem.

The same float32 residual pieces (JAX's, evaluated at a float64 reference
iterate of ``tests/goldens/golden_ref_step.npz``, env 1) go into the port's
``df32_step_from_residuals``, JAX's two-float ``df32_step_from_residuals``
and JAX's float64 assembly and solve of those residuals (the "f32r floor" of
tests/test_twofloat.py).  On the CPU the port's step is that floor (native
float64 in place of two-float): its float64 value before the cast equals
JAX's floor to 1e-12 relative, and its float32 result is within 5e-4
absolute of JAX's df32 step (whose engine term measured 3.2e-4 at worst,
tests/test_twofloat.py).  JAX's df32 step is called once under GN and once
under LM (seconds each on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import df32 as jdf32
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.ops import tridiag as jtridiag
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu_torch.core import df32 as tdf32
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.robots import PointRobot2D as TPointRobot2D

from _torch_parity import np_

torch.set_num_threads(1)
GOLDEN = "tests/goldens/golden_ref_step.npz"
J_EVAL = jax.jit(jg.eval_residuals, static_argnums=(0, 1))
J_ASM = jax.jit(jg.assemble_from_residuals, static_argnums=(0,))


@pytest.fixture(scope="module", autouse=True)
def _reference_oob_mode():
    """The goldens' lookup convention, in both packages (as
    tests/test_twofloat.py sets it for JAX)."""
    jsdf.set_oob_mode("reference")
    tsdf.set_oob_mode("reference")
    yield
    jsdf.set_oob_mode("intended")
    tsdf.set_oob_mode("intended")


@pytest.fixture(scope="module")
def golden():
    from pathlib import Path

    return np.load(Path(__file__).resolve().parents[1] / GOLDEN)


def specs(g, **kw):
    opts = dict(total_time_step=int(g["total_time_step"]),
                total_time_sec=float(g["total_time_sec"]),
                x_lims=tuple(float(v) for v in g["x_lims"]),
                y_lims=tuple(float(v) for v in g["y_lims"]), **kw)
    radii = (float(g["sphere_radius"]),)
    return ((jg.GraphSpec(**opts), JPointRobot2D(sphere_radii=radii)),
            (tg.GraphSpec(**opts), TPointRobot2D(sphere_radii=radii)))


def params(g, env, dtype, jax_side, spec, robot, b=1):
    """The golden env's params (its start and goal, b times)."""
    start = np.repeat(g[f"start_{env}"], b, 0)
    goal = np.repeat(g[f"goal_{env}"], b, 0)
    kw = dict(qc_inv=g["qc_inv"], cost_sigma=float(g["cost_sigma"]),
              epsilon_dist=float(g["epsilon_dist"]), k_s=g["k_s"],
              k_g=g["k_g"])
    if jax_side:
        return jg.default_params(spec, robot, jnp.asarray(start, dtype),
                                 jnp.asarray(goal, dtype), dtype=dtype, **kw)
    return tg.default_params(spec, robot, torch.tensor(start, dtype=dtype),
                             torch.tensor(goal, dtype=dtype), dtype=dtype,
                             **kw)


def residuals_to_torch(res_j):
    return tg.FactorResiduals(**{
        f.name: None if getattr(res_j, f.name) is None
        else torch.tensor(np.asarray(getattr(res_j, f.name)))
        for f in dataclasses.fields(tg.FactorResiduals)})


def f32_point(g, env="1", it=0, b=1):
    """Both packages' float32 params and JAX's float32 residuals at the
    reference's iterate ``it`` of ``env``, b times; JAX's params upcast."""
    (sj, rj), (st, rt) = specs(g)
    th = np.repeat(g[f"th_{env}"][it], b, 0).astype(np.float32)
    sdf = np.repeat(g[f"sdf_{env}"][None], b, 0).astype(np.float32)
    pj32 = params(g, env, jnp.float32, True, sj, rj, b)
    res_j = J_EVAL(sj, rj, pj32, jnp.asarray(th), jnp.asarray(sdf))
    # The floor's params: the float32 plan's, upcast (exactly).
    pj64 = jax.tree.map(lambda a: a.astype(jnp.float64), pj32)
    return (sj, pj32, pj64, res_j, st,
            params(g, env, torch.float32, False, st, rt, b),
            residuals_to_torch(res_j))


def jax_floor(sj, pj64, res_j, delta, lm):
    res64 = jax.tree.map(lambda a: a.astype(jnp.float64), res_j)
    diag, off, rhs = J_ASM(sj, pj64, res64)
    return jtridiag.btd_solve_auto(*jgn.damped_system(
        diag, off, rhs, jnp.asarray(delta, jnp.float64), trust_region=lm))


def rel(got, want):
    want = np_(want)
    return float(np.abs(np_(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("method", ["gn", "lm"])
def test_df32_step_is_the_floor_and_near_jax_df32(golden, method):
    sj, pj32, pj64, res_j, st, pt32, res_t = f32_point(golden)
    lm = method == "lm"
    # LM: a per-problem lambda, as tests/test_twofloat.py's LM case.
    delta = np.array([0.01], np.float32) if lm else float(golden["reg"])
    floor = jax_floor(sj, pj64, res_j, delta, lm)
    want_df = jdf32.df32_step_from_residuals(
        sj, pj32, res_j, jnp.asarray(delta) if lm else delta,
        trust_region=lm)
    t_delta = torch.tensor(delta) if lm else delta
    got = tdf32.df32_step_from_residuals(st, pt32, res_t, t_delta, lm)
    got64 = tdf32.floor_step(st, pt32, res_t, t_delta, lm)
    assert got.dtype == torch.float32
    assert torch.equal(got, got64.to(torch.float32))
    assert rel(got64, floor) <= 1e-12
    gap = float(np.abs(np_(got).astype(np.float64)
                       - np_(want_df).astype(np.float64)).max())
    assert gap <= 5e-4, gap


def test_df32_lm_per_problem_lambda(golden):
    """Three problems at the same point with their own lambdas: each row
    is its own damped float64 solve."""
    sj, _, pj64, res_j, st, pt32, res_t = f32_point(golden, it=3, b=3)
    lam = np.array([1e-3, 1e-2, 1e-1], np.float32)
    floor = jax_floor(sj, pj64, res_j, lam, True)
    got64 = tdf32.floor_step(st, pt32, res_t, torch.tensor(lam), True)
    got = tdf32.df32_step_from_residuals(st, pt32, res_t, torch.tensor(lam),
                                         trust_region=True)
    assert rel(got64, floor) <= 1e-12
    assert torch.equal(got, got64.to(torch.float32))
    for i in range(3):
        one = jax_floor(sj, jax.tree.map(lambda a: a[i:i + 1], pj64),
                        jax.tree.map(lambda a: None if a is None
                                     else a[i:i + 1], res_j), lam[i:i + 1],
                        True)
        assert rel(got64[i:i + 1], one) <= 1e-12


def test_df32_refuses_float64_and_factors_out_of_scope(golden):
    (sj, rj), (st, rt) = specs(golden)
    p64 = params(golden, "1", torch.float64, False, st, rt)
    th = torch.tensor(golden["th_1"][0])
    sdf = torch.tensor(golden["sdf_1"])[None]
    with pytest.raises(ValueError, match="df32"):
        tgn.plan(st, rt, p64, th, sdf, tgn.OptimConfig(engine="df32",
                                                       max_iters=2))
    res64 = tg.eval_residuals(st, rt, p64, th, sdf)
    with pytest.raises(ValueError, match="df32"):
        tdf32.df32_step_from_residuals(st, p64, res64, 0.1)
    for opt in (dict(use_gp_inter=True),):
        (_, _), (st_o, rt_o) = specs(golden, **opt)
        p32 = params(golden, "1", torch.float32, False, st_o, rt_o)
        res = tg.eval_residuals(st_o, rt_o, p32, th.float(), sdf.float())
        with pytest.raises(NotImplementedError):
            tdf32.df32_step_from_residuals(st_o, p32, res, 0.1)
    # The workspace goal (a 3-link arm's tip) is out of scope too.
    from dgpmp2_tpu_torch.robots import PlanarArmNLink

    arm = PlanarArmNLink(link_lengths=(1.8, 1.4, 1.2), spheres_per_link=2,
                         sphere_radii=(0.25,))
    spec_w = tg.GraphSpec(dof=3, state_dim=6, total_time_step=6,
                          nlinks=arm.nlinks, use_workspace_goal=True)
    pw = tg.default_params(spec_w, arm, torch.zeros(1, 6), torch.zeros(1, 6),
                           qc_inv=np.eye(3), cost_sigma=0.1,
                           epsilon_dist=0.2, k_s=0.01, k_g=0.01, k_wg=0.1,
                           workspace_goal=np.array([[2.0, 1.0]]))
    img = torch.ones(1, 32, 32)
    res_w = tg.eval_residuals(spec_w, arm, pw, torch.zeros(1, 7, 6),
                              tsdf.sdf_from_occupancy(img, res=10.0 / 32))
    with pytest.raises(NotImplementedError):
        tdf32.df32_step_from_residuals(spec_w, pw, res_w, 0.1)


def test_df32_plan_tracks_the_float64_plan(golden):
    """Closed loop on env 5 (tests/test_twofloat.py's smooth basin): the
    port's float32 plan under engine='df32' within 1e-3 of JAX's float64
    standard plan over 8 iterations."""
    (sj, rj), (st, rt) = specs(golden)
    reg = float(golden["reg"])
    sdf = golden["sdf_5"][None]
    th0 = golden["th_5"][0]
    want = jgn.plan(sj, rj, params(golden, "5", jnp.float64, True, sj, rj),
                    jnp.asarray(th0), jnp.asarray(sdf),
                    jgn.OptimConfig(reg=reg, max_iters=8, tol_delta=0.0))
    got = tgn.plan(st, rt, params(golden, "5", torch.float32, False, st, rt),
                   torch.tensor(th0, dtype=torch.float32),
                   torch.tensor(sdf, dtype=torch.float32),
                   tgn.OptimConfig(reg=reg, max_iters=8, tol_delta=0.0,
                                   engine="df32"))
    assert got.th.dtype == torch.float32
    gap = float(np.abs(np_(got.th).astype(np.float64) - np_(want.th)).max())
    assert gap < 1e-3, gap
