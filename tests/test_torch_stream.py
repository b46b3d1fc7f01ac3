"""The port's stream engine against the JAX package's stream engine.

JAX's engine runs its streaming Pallas solve in interpret mode on the CPU,
as tests/test_gn_stream.py runs it (``stream.CHUNK`` set to 4, T = 7), which
costs seconds a call: so this file holds the port to it on the
``point_gn`` and ``point_lm`` configurations of that file only (one
``stream_step`` each at 1e-10, a 5-iteration plan at 1e-8, gradients with
respect to the obstacle Λ and Q⁻¹ at 1e-8); test_torch_stream_families.py
holds every family against JAX's standard path.  Float64 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.core import stream as jstream
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_straight
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.core import stream as tstream
from dgpmp2_tpu_torch.robots import PointRobot2D as TPointRobot2D

from _torch_parity import F64, np_, params_arrays

torch.set_num_threads(1)
B, T = 2, 7


@pytest.fixture(autouse=True)
def small_stream_chunk(monkeypatch):
    """JAX's streaming chunk at 4, as tests/test_gn_stream.py sets it."""
    monkeypatch.setattr(jstream, "CHUNK", 4)


@pytest.fixture(scope="module")
def pair():
    """tests/test_gn_stream.py's point problem (B=2, T=7, a 32² world with
    one square obstacle) in both packages."""
    img = np.ones((B, 32, 32))
    img[:, 12:20, 12:20] = 0.0
    sdf_j = jsdf.sdf_from_occupancy(jnp.asarray(img, jnp.float64),
                                    res=10.0 / 32)
    start = np.zeros((B, 4))
    start[:, :2] = -4.0
    goal = np.zeros((B, 4))
    goal[:, :2] = 4.0
    spec_j = jg.GraphSpec(total_time_step=T)
    params_j = jg.default_params(
        spec_j, JPointRobot2D(), jnp.asarray(start), jnp.asarray(goal),
        dtype=jnp.float64, qc_inv=np.eye(2), cost_sigma=0.1,
        epsilon_dist=0.4, k_s=0.01, k_g=0.01)
    th_j = j_straight(jnp.asarray(start[:, :2]), jnp.asarray(goal[:, :2]),
                      10.0, T)
    spec_t = tg.GraphSpec(total_time_step=T)
    params_t = convert.graph_params_from_numpy(params_arrays(params_j), "cpu",
                                               F64)
    return ((spec_j, JPointRobot2D(), params_j, th_j, sdf_j),
            (spec_t, TPointRobot2D(), params_t, torch.tensor(np_(th_j)),
             torch.tensor(np_(sdf_j))))


def rel(got, want):
    want = np_(want)
    return float(np.abs(np_(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("method", ["gauss_newton", "lm"],
                         ids=["point_gn", "point_lm"])
def test_stream_step_matches_jax_stream_step(pair, method):
    (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft) = pair
    lm = method == "lm"
    delta = np.array([1e-2, 1.0]) if lm else 0.1
    res_j = jg.eval_residuals(sj, rj, pj, thj, sdfj)
    ss_j = jstream.build_stream_static(
        sj, pj, jg.assemble_static(sj, pj, jnp.float64), B, jnp.float64,
        0.0 if lm else delta)
    want = jstream.stream_step(sj, pj, ss_j, res_j, jnp.asarray(delta), lm,
                               interpret=True)
    res_t = tg.FactorResiduals(**{
        f.name: None if getattr(res_j, f.name) is None
        else torch.tensor(np_(getattr(res_j, f.name)))
        for f in dataclasses.fields(tg.FactorResiduals)})
    ss_t = tstream.build_stream_static(
        st, pt, tg.assemble_static(st, pt, F64), B, F64, 0.0 if lm else delta)
    got = tstream.stream_step(st, pt, ss_t, res_t,
                              torch.tensor(delta, dtype=F64), lm)
    assert rel(got, want) <= 1e-10
    # The standalone step is stream_step on its own residuals.
    got1 = tstream.gn_step_stream(st, rt, pt, tht, sdft,
                                  torch.tensor(delta, dtype=F64), lm)
    own = tstream.stream_step(st, pt, ss_t,
                              tg.eval_residuals(st, rt, pt, tht, sdft),
                              torch.tensor(delta, dtype=F64), lm)
    assert torch.equal(got1, own)


def test_stream_plan_matches_jax_stream_plan(pair):
    (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft) = pair
    kw = dict(engine="stream", reg=0.1, max_iters=5, tol_delta=0.0)
    want = jgn.plan(sj, rj, pj, thj, sdfj, jgn.OptimConfig(**kw))
    got = tgn.plan(st, rt, pt, tht, sdft, tgn.OptimConfig(**kw))
    for name in ("th", "err_final", "err_per_iter", "err_ext_per_iter"):
        assert rel(getattr(got, name), getattr(want, name)) <= 1e-8, name
    assert np.array_equal(np_(got.iters), np_(want.iters))


def test_stream_gradients_match_jax(pair):
    """d/d(obs_inv, q_inv) of a weighted sum of a 3-iteration stream plan's
    trajectories and external errors."""
    (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft) = pair
    kw = dict(engine="stream", reg=0.1, max_iters=3, tol_delta=0.0)
    w = np.random.default_rng(0).standard_normal((B, T + 1, 4))

    def loss_j(obs, q):
        out = jgn.plan(sj, rj, pj.replace(obs_inv=obs, q_inv=q), thj, sdfj,
                       jgn.OptimConfig(**kw))
        return jnp.sum(out.th * w) + jnp.sum(out.err_ext_per_iter)

    g_obs, g_q = jax.grad(loss_j, argnums=(0, 1))(pj.obs_inv, pj.q_inv)
    obs = pt.obs_inv.clone().requires_grad_(True)
    q = pt.q_inv.clone().requires_grad_(True)
    out = tgn.plan(st, rt, dataclasses.replace(pt, obs_inv=obs, q_inv=q),
                   tht, sdft, tgn.OptimConfig(**kw))
    (torch.sum(out.th * torch.tensor(w))
     + torch.sum(out.err_ext_per_iter)).backward()
    assert rel(obs.grad, g_obs) <= 1e-8
    assert rel(q.grad, g_q) <= 1e-8


def test_resolve_engine():
    """``auto`` is the standard engine on every device and dtype (JAX's
    picks stream on its TPU); the four names resolve; others raise."""
    for dtype in (None, torch.float32, torch.float64):
        assert tgn.resolve_engine("auto", dtype) == "standard"
    for name in ("standard", "stream", "df32"):
        assert tgn.resolve_engine(name) == name
    assert tgn.ENGINES == jgn._ENGINES
    with pytest.raises(ValueError, match="unknown engine"):
        tgn.resolve_engine("streaming")
    with pytest.raises(ValueError, match="unknown engine"):
        jgn.resolve_engine("streaming", jnp.float32)


def _short_pair(t):
    """A batch of 9 point problems of ``t`` GP steps (``t`` + 1 states) in a
    32² world of one square obstacle, seeded from numpy: starts and goals
    differ by problem, and the iterate's states lie about the obstacle."""
    rng = np.random.default_rng(9 + t)
    b = 9
    img = np.ones((b, 32, 32))
    img[:, 12:20, 12:20] = 0.0
    sdf_j = jsdf.sdf_from_occupancy(jnp.asarray(img, jnp.float64),
                                    res=10.0 / 32)
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    th = np.concatenate([rng.uniform(-1.5, 1.5, (b, t + 1, 2)),
                         rng.normal(0, 0.3, (b, t + 1, 2))], -1)
    spec_j = jg.GraphSpec(total_time_step=t)
    params_j = jg.default_params(
        spec_j, JPointRobot2D(), jnp.asarray(start), jnp.asarray(goal),
        dtype=jnp.float64, qc_inv=np.eye(2), cost_sigma=0.1,
        epsilon_dist=0.4, k_s=0.01, k_g=0.01)
    spec_t = tg.GraphSpec(total_time_step=t)
    params_t = convert.graph_params_from_numpy(params_arrays(params_j), "cpu",
                                               F64)
    return ((spec_j, JPointRobot2D(), params_j, jnp.asarray(th), sdf_j),
            (spec_t, TPointRobot2D(), params_t, torch.tensor(th),
             torch.tensor(np_(sdf_j))))


@pytest.mark.parametrize("t1", [2, 3])
@pytest.mark.parametrize("method", ["gauss_newton", "lm"],
                         ids=["point_gn", "point_lm"])
def test_stream_step_matches_jax_at_short_horizons(method, t1):
    """The port's stream step (its plain version on the CPU) against JAX's
    ``stream_step`` in float64 at T1 = 2 and 3 states and a batch of 9
    (the shapes at which the card's kernel fills fewer ring stages than it
    has, and its last block holds fewer problems than it could), GN with
    reg 0.1 and LM with a damping a problem; 1e-10 relative."""
    (sj, rj, pj, thj, sdfj), (st, rt, pt, tht, sdft) = _short_pair(t1 - 1)
    lm = method == "lm"
    b = thj.shape[0]
    delta = (10.0 ** np.random.default_rng(t1).uniform(-3, 0, b) if lm
             else 0.1)
    res_j = jg.eval_residuals(sj, rj, pj, thj, sdfj)
    ss_j = jstream.build_stream_static(
        sj, pj, jg.assemble_static(sj, pj, jnp.float64), b, jnp.float64,
        0.0 if lm else delta)
    want = jstream.stream_step(sj, pj, ss_j, res_j, jnp.asarray(delta), lm,
                               interpret=True)
    res_t = tg.eval_residuals(st, rt, pt, tht, sdft)
    assert float(res_t.r_obs.abs().max()) > 0  # the obstacle family counts
    ss_t = tstream.build_stream_static(
        st, pt, tg.assemble_static(st, pt, F64), b, F64, 0.0 if lm else delta)
    got = tstream.stream_step(st, pt, ss_t, res_t,
                              torch.tensor(delta, dtype=F64), lm)
    assert got.shape == (b, t1, 4)
    assert rel(got, want) <= 1e-10
