"""The port's stream engine on every factor family, against the JAX
package's standard path, and K-STREAM's plain version against the port's
standard engine.

Float64 on the CPU.  The same residuals (JAX's, handed to the port) go
through the port's ``stream.stream_step`` and through JAX's
``assemble_from_residuals`` + ``damped_system`` + ``btd_solve_auto`` under GN
and LM: 1e-10 relative.  The JAX stream engine itself runs in Pallas
interpret mode and is held against the port in test_torch_stream.py.
Then the engine through the YAML planner, multistart and the service, each
against the standard engine at 5 GN iterations (1e-10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.ops import tridiag as jtridiag
from dgpmp2_tpu_torch import serve as tserve
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.core import stream as tstream
from dgpmp2_tpu_torch.ops import tridiag as ttridiag
from dgpmp2_tpu_torch.ops.cuda import btd_stream

from _torch_parity import F64, both_problems, both_problems_3d, np_
import test_torch_constraints as tc

torch.set_num_threads(1)
TOL = 1e-10
J_EVAL = jax.jit(jg.eval_residuals, static_argnums=(0, 1))
J_ASM = jax.jit(jg.assemble_from_residuals, static_argnums=(0,))


# case -> (how its problem is made, with what); the constrained cases come
# from test_torch_constraints (T = 12, B = 3), the rest are built here.
CASES = {
    "point": ("both", {}),
    "point3d": ("both3d", {}),
    "arm_links": ("constraints", "self_collision"),
    "non_holonomic": ("constraints", "non_holonomic"),
    "vel_limits": ("constraints", "vel_limits"),
    "gp_inter": ("constraints", "gp_inter"),
    "self_joint": ("constraints", "arm_yaml"),
    "workspace_goal": ("constraints", "arm3_task"),
    "gp_inter_vel": ("constraints", "gp_inter_vel"),
    "all": ("constraints", "all"),
    "learned_cov": ("learned", {}),
}
_CACHE = {}


def _learned():
    """The point problem with per-problem, per-step covariances (batch
    stride B): random SPD Q⁻¹ and obstacle Λ, as a learned head gives."""
    (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft) = both_problems(
        seed=3, b=3, t=12, n=32)
    rng = np.random.default_rng(7)
    b, t, d = 3, 12, 4
    g = rng.standard_normal((b, t, d, d)) * 0.3
    q = np.asarray(pj.q_inv) + np.einsum("btij,btkj->btik", g, g) * 50.0
    obs = np.asarray(pj.obs_inv) * rng.uniform(0.5, 2.0, (b, t + 1, 1, 1))
    pj = dataclasses.replace(pj, q_inv=jnp.asarray(q),
                             obs_inv=jnp.asarray(obs))
    pt = dataclasses.replace(pt, q_inv=torch.tensor(q),
                             obs_inv=torch.tensor(obs))
    return (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft)


def problem(name):
    if name not in _CACHE:
        kind, arg = CASES[name]
        if kind == "both":
            pj, pt = both_problems(seed=2, b=3, t=12, n=32)
        elif kind == "both3d":
            pj, pt = both_problems_3d(seed=2, b=3, t=12, n=16)
        elif kind == "learned":
            pj, pt = _learned()
        else:
            pj, pt = tc.build(arg)
        res_j = J_EVAL(*pj)
        _CACHE[name] = (pj, pt, res_j, residuals_to_torch(res_j))
    return _CACHE[name]


def residuals_to_torch(res_j) -> tg.FactorResiduals:
    return tg.FactorResiduals(**{
        f.name: None if getattr(res_j, f.name) is None
        else torch.tensor(np.asarray(getattr(res_j, f.name)))
        for f in dataclasses.fields(tg.FactorResiduals)})


def jax_step(spec, params, res, delta, lm):
    diag, off, rhs = J_ASM(spec, params, res)
    return jtridiag.btd_solve_auto(*jgn.damped_system(diag, off, rhs, delta,
                                                      trust_region=lm))


def rel(got, want):
    want = np_(want)
    return float(np.abs(np_(got) - want).max() / np.abs(want).max())


DELTAS = {"gn": 0.1, "lm": np.array([1e-3, 1e-1, 10.0])}


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_step_matches_jax_standard_path(name, method):
    (sj, _, pj, _, _), (st, _, pt, _, _), res_j, res_t = problem(name)
    lm = method == "lm"
    delta = DELTAS[method]
    want = jax_step(sj, pj, res_j, jnp.asarray(delta), lm)
    static = tg.assemble_static(st, pt, F64)
    ss = tstream.build_stream_static(st, pt, static, 3, F64,
                                     reg=0.0 if lm else delta)
    got = tstream.stream_step(st, pt, ss, res_t, torch.tensor(delta), lm)
    assert got.dtype == F64 and got.shape == res_t.r_s.shape[:1] + (
        st.num_traj_states, st.state_dim)
    assert rel(got, want) <= TOL, (name, method, rel(got, want))


@pytest.mark.parametrize("name", ["point", "self_joint", "workspace_goal",
                                  "gp_inter_vel", "learned_cov"])
def test_plain_version_matches_the_standard_engine(name):
    """K-STREAM's plain version, on the kernel's own arguments (the
    StreamStatic blocks with their batch strides, the families and the
    addends), against the port's standard assembly, damping and plain
    solve; its system's lower triangles against the standard assembly's."""
    _, (st, _, pt, _, _), _, res = problem(name)
    lam = torch.tensor([1e-3, 1e-1, 10.0], dtype=F64)
    ss = tstream.build_stream_static(st, pt, None, 3, F64)
    # The constrained cases' params come from the port's default_params,
    # whose blocks every problem shares; "point" carries JAX's params, one
    # copy a problem, and "learned_cov" differs per problem.
    shared = name not in ("point", "learned_cov")
    assert (ss.diag.shape[0] == 1) == shared
    assert (ss.q_inv.shape[0] == 1) == shared
    args = (ss.diag, ss.off, ss.phiT_q, ss.q_inv, ss.ks_inv, ss.kg_inv,
            res.r_gp, res.r_s, res.r_g, tstream.families(st, ss, res))
    diag_add, off_add, rhs_add = tstream.addends(st, pt, res, F64)
    kw = dict(diag_add=diag_add, off_add=off_add, rhs_add=rhs_add, delta=lam)
    got = btd_stream.plain(*args, **kw)
    sys = tgn.damped_system(*tg.assemble_from_residuals(st, pt, res), lam,
                            trust_region=True)
    want = ttridiag.btd_solve(*sys)
    assert rel(got, want) <= 1e-12
    diag, off, rhs = btd_stream.plain_system(*args, **kw)
    low = torch.ones(st.state_dim, st.state_dim, dtype=torch.bool).tril()
    assert rel(diag[..., low], sys[0][..., low]) <= 1e-12
    assert rel(off, sys[1]) <= 1e-12
    assert rel(rhs, sys[2]) <= 1e-12


def test_stream_gradient_matches_standard_on_the_cpu():
    """The plain version differentiates as the standard engine does
    (obstacle Λ and Q⁻¹, per problem)."""
    _, (st, _, pt, _, _), _, res = problem("learned_cov")
    grads = []
    for engine in ("stream", "standard"):
        obs = pt.obs_inv.clone().requires_grad_(True)
        q = pt.q_inv.clone().requires_grad_(True)
        p = dataclasses.replace(pt, obs_inv=obs, q_inv=q)
        if engine == "stream":
            ss = tstream.build_stream_static(st, p, None, 3, F64, reg=0.1)
            x = tstream.stream_step(st, p, ss, res)
        else:
            x = ttridiag.btd_solve(*tgn.damped_system(
                *tg.assemble_from_residuals(st, p, res), 0.1))
        (x * torch.linspace(-1, 1, x.numel(), dtype=F64).reshape(
            x.shape)).sum().backward()
        grads.append((obs.grad, q.grad))
    for g, w in zip(*grads):
        assert rel(g, w) <= 1e-10


def _yaml_planner(engine, iters=5, dim="2d", t=12):
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot
    from dgpmp2_tpu_torch.utils.config import CONFIG_DIR, load_params

    env, pp, gp, obs, opt, rd = load_params(
        CONFIG_DIR / f"gpmp2_{dim}_params.yaml", CONFIG_DIR / f"robot_{dim}.yaml",
        CONFIG_DIR / f"env_{dim}_params.yaml")
    lims = {k: env[k] for k in ("x_lims", "y_lims", "z_lims") if k in env}
    return DiffGPMP2Planner(gp, obs, dict(pp, total_time_step=t),
                            dict(opt, engine=engine, max_iters=iters,
                                 tol_delta=0.0),
                            lims, make_robot(rd), dtype=F64, device="cpu")


def test_yaml_stream_planner_plans_as_gn_plan():
    """``engine: stream`` under ``optim_params`` reaches gn.plan through
    utils.config and DiffGPMP2Planner; the YAML blocks stay shared."""
    planner = _yaml_planner("stream")
    assert planner.cfg.engine == "stream"
    _, (_, _, pt, th, sdf), _, _ = problem("point")
    start, goal = np_(pt.start), np_(pt.goal)
    got = planner.plan(th, start, goal, sdf)
    params = planner.make_params(start, goal)
    assert params.q_inv.stride(0) == 0
    want = tgn.plan(planner.spec, planner.robot, params, th, sdf, planner.cfg)
    assert torch.equal(got.th, want.th)
    std = tgn.plan(planner.spec, planner.robot, params, th, sdf,
                   dataclasses.replace(planner.cfg, engine="standard"))
    assert rel(got.th, std.th) <= TOL
    assert rel(got.err_final, std.err_final) <= TOL


def test_multistart_passes_the_stream_engine_through():
    _, (st, rt, pt, th, sdf), _, _ = problem("point")
    normals = torch.tensor(np.random.default_rng(5).standard_normal(
        (4, 3, 3, 2)))
    out = {}
    for engine in ("stream", "standard"):
        cfg = tgn.OptimConfig(engine=engine, max_iters=5, tol_delta=0.0)
        out[engine] = tms.plan_multistart(st, rt, pt, th, sdf, cfg, None,
                                          restarts=4, normals=normals)
    assert rel(out["stream"].th, out["standard"].th) <= TOL
    assert torch.equal(out["stream"].k_best, out["standard"].k_best)


def test_served_request_passes_the_stream_engine_through():
    _, (_, _, pt, _, sdf), _, _ = problem("point")
    req = [tserve.PlanRequest(start=np_(pt.start[i]), goal=np_(pt.goal[i]),
                              sdf=np_(sdf[i])) for i in range(2)]
    got = {}
    for engine in ("stream", "standard"):
        svc = tserve.PlanningService(_yaml_planner(engine), batch_size=2)
        got[engine] = svc.plan_batch_sync(req)
    for g, w in zip(got["stream"], got["standard"]):
        assert rel(g.th, w.th) <= TOL
        assert g.iters == w.iters
