"""dgpmp2_tpu_torch.core.multistart against dgpmp2_tpu.core.multistart.

The two packages draw their seed perturbations from different random
sources (a torch.Generator, a JAX PRNG key), so the comparisons use draws
that do not depend on the source: restart 0 is always the unperturbed base,
the informed candidates are numpy-made ``extra_seeds``, and the
deterministic part of ``perturbed_inits`` is fed JAX's own normals.

Float64 on the CPU, B=3, T=16, 32x32 worlds: trajectories to 1e-8, the
selected candidates and iteration counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.planner import GPMP2Planner as JGPMP2Planner
from dgpmp2_tpu_torch import robots as tr
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.planner import GPMP2Planner

from _torch_parity import F64, both_problems, np_, world

torch.set_num_threads(1)
B, T = 3, 16


def extra_seeds(th0, n, seed, dup=True):
    """n numpy-made candidates (n, B, T+1, D) around the base: smooth
    interior bumps, endpoints kept; with ``dup`` the last repeats the first,
    so selection meets exact ties."""
    rng = np.random.default_rng(seed)
    th0 = np_(th0)
    s = np.linspace(0.0, 1.0, th0.shape[1])[None, None, :, None]
    amp = rng.normal(0.0, 1.0, (n, th0.shape[0], 1, th0.shape[2]))
    out = th0[None] + amp * np.sin(np.pi * s) * np.sin(2 * np.pi * s * (
        1 + np.arange(n)[:, None, None, None] % 3))
    if dup:
        out[-1] = out[0]
    return out


def jax_ms(spec, robot, params, th, sdf, cfg, extra, **kw):
    """dgpmp2_tpu's plan_multistart with restarts=1 plus ``extra``, jitted
    (one compile is faster than eager dispatch)."""
    def run(p, t, s, e):
        return jms.plan_multistart(
            spec, robot, p, t, s, jgn.OptimConfig(engine="standard", **cfg),
            jax.random.PRNGKey(0), restarts=1, extra_seeds=e, **kw)

    return jax.jit(run)(params, th, sdf, jnp.asarray(extra))


def compare(got, want):
    for name in ("th", "score"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    for name in ("k_best", "contact_free", "iters"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)


@pytest.fixture(scope="module")
def problems():
    return both_problems(seed=2, b=B, t=T, n=32)


def test_inits_from_normals_match_jax_perturbed_inits():
    th0 = np.random.default_rng(0).standard_normal((B, T + 1, 4))
    key = jax.random.PRNGKey(3)
    want = jms.perturbed_inits(jnp.asarray(th0), key, 5, 1.5, 10.0)
    z = jax.random.normal(key, (5, B, 3, 2), jnp.float64)
    got = tms.inits_from_normals(torch.tensor(th0), torch.tensor(np_(z)),
                                 1.5, 10.0)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-12, atol=1e-12)


def test_perturbed_inits_keep_the_base_and_the_endpoints():
    th0 = torch.tensor(np.random.default_rng(1).standard_normal((B, T + 1, 6)))
    seeds = tms.perturbed_inits(th0, torch.Generator().manual_seed(4), 6, 2.0,
                                10.0, harmonics=2)
    again = tms.perturbed_inits(th0, torch.Generator().manual_seed(4), 6,
                                2.0, 10.0, harmonics=2)
    assert seeds.shape == (6, B, T + 1, 6) and torch.equal(seeds, again)
    assert torch.equal(seeds[0], th0)
    ends = seeds[:, :, [0, -1]] - th0[None, :, [0, -1]]
    assert float(ends.abs().max()) <= 1e-12
    assert float((seeds[1:] - th0).abs().max()) > 0.1


def test_tile_params_matches_jax(problems):
    (_, _, p_j, _, _), (_, _, p_t, _, _) = problems
    got, want = tms.tile_params(p_t, B, 3), jms.tile_params(p_j, B, 3)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(np_(a), np_(b), err_msg=f.name)


@pytest.mark.parametrize("staged", [False, True])
def test_plan_multistart_matches_jax(problems, staged):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    extra = extra_seeds(th_t, 5, 7)
    kw = dict(prune_iters=2, keep=3) if staged else {}
    cfg = dict(reg=0.1, max_iters=6)
    want = jax_ms(spec_j, robot_j, p_j, th_j, sdf_j, cfg, extra, **kw)
    got = tms.plan_multistart(
        spec_t, robot_t, p_t, th_t, sdf_t, tgn.OptimConfig(**cfg),
        torch.Generator().manual_seed(0), restarts=1,
        extra_seeds=torch.tensor(extra), **kw)
    compare(got, want)
    # The pool's duplicate (last extra seed = first) never displaces the
    # lower index on a tie.
    assert not bool((got.k_best == 5).any()) or staged


def test_select_margin_matches_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    extra = extra_seeds(th_t, 4, 9, dup=False)
    for margin in (0.3, 1.0):
        want = jax_ms(spec_j, robot_j, p_j, th_j, sdf_j,
                      dict(reg=0.1, max_iters=4), extra, select_margin=margin)
        got = tms.plan_multistart(
            spec_t, robot_t, p_t, th_t, sdf_t,
            tgn.OptimConfig(reg=0.1, max_iters=4),
            torch.Generator().manual_seed(0), restarts=1,
            extra_seeds=torch.tensor(extra), select_margin=margin)
        compare(got, want)


def _task_problems():
    """The task-space 3-link arm (workspace goal, self-collision, joint
    limits) in both packages: (spec, robot, params, th0, sdf) each."""
    out = []
    imgs, _, _ = world(4, B, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 32))
    rng = np.random.default_rng(4)
    start = np.zeros((B, 6))
    start[:, :3] = rng.uniform(-0.5, 0.5, (B, 3))
    target = rng.uniform(1.5, 3.0, (B, 2))
    th0 = np.repeat(start[:, None], T + 1, axis=1)
    for lib, g, xp, dtype in ((jr, jg, jnp.asarray, jnp.float64),
                              (tr, tg, torch.tensor, F64)):
        arm = lib.PlanarArmNLink(link_lengths=(1.8, 1.4, 1.2),
                                 spheres_per_link=2, sphere_radii=(0.25,))
        spec = g.GraphSpec(total_time_step=T, dof=3, state_dim=6,
                           nlinks=arm.nlinks, use_workspace_goal=True,
                           use_joint_limits=True, use_self_collision=True,
                           self_pairs=lib.self_collision_pairs(arm))
        params = g.default_params(
            spec, arm, xp(start), xp(start), qc_inv=np.eye(3),
            cost_sigma=0.05, epsilon_dist=0.25, k_s=0.001, k_g=100.0,
            k_wg=0.01, workspace_goal=xp(target), k_jl=0.01,
            q_min=(-2.4,) * 3, q_max=(2.4,) * 3, k_self=0.02, eps_self=0.05,
            dtype=dtype)
        out.append((spec, arm, params, xp(th0), xp(sdf)))
    return out


@pytest.mark.parametrize("staged", [False, True])
def test_workspace_goal_selection_matches_jax(staged):
    """Under a workspace goal each candidate is its final iterate and the
    tip error joins the score (LM: the task-space arm's GN steps are
    violent)."""
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = _task_problems()
    extra = extra_seeds(th_t, 3, 11, dup=False)
    kw = dict(prune_iters=2, keep=2) if staged else {}
    cfg = dict(method="lm", reg=0.1, max_iters=5)
    want = jax_ms(spec_j, robot_j, p_j, th_j, sdf_j, cfg, extra, **kw)
    got = tms.plan_multistart(
        spec_t, robot_t, p_t, th_t, sdf_t, tgn.OptimConfig(**cfg),
        torch.Generator().manual_seed(0), restarts=1,
        extra_seeds=torch.tensor(extra), **kw)
    compare(got, want)
    with pytest.raises(ValueError, match="needs params"):
        tms.score_candidates(spec_t, robot_t, th_t, sdf_t)


def test_score_candidates_with_gp_inter_and_self_collision_match_jax():
    """Contact over the interpolated states and body pairs, the margin term
    and a diverged (NaN) candidate, on random arm candidates."""
    rng = np.random.default_rng(6)
    th = np.concatenate([rng.uniform(-3.0, 3.0, (6, T + 1, 2)),
                         rng.normal(0.0, 0.5, (6, T + 1, 2))], -1)
    th[2, 5, 0] = np.nan
    imgs, _, _ = world(6, 6, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 32))
    results = []
    for lib, g, score, xp in (
            (jr, jg, jax.jit(jms.score_candidates, static_argnums=(0, 1),
                             static_argnames="select_margin"), jnp.asarray),
            (tr, tg, tms.score_candidates, torch.tensor)):
        arm = lib.PlanarArm2Link(sphere_radii=(0.25,) * 6)
        spec = g.GraphSpec(total_time_step=T, nlinks=6, use_gp_inter=True,
                           num_inter=2, use_self_collision=True,
                           self_pairs=lib.self_collision_pairs(arm))
        results.append(score(spec, arm, xp(th), xp(sdf), select_margin=0.2))
    (s_j, c_j), (s_t, c_t) = results
    np.testing.assert_allclose(np_(s_t), np_(s_j), rtol=1e-10)
    np.testing.assert_allclose(np_(c_t), np_(c_j), rtol=1e-10, atol=1e-12)
    assert np.isinf(np_(s_t)[2]) and (np_(c_t)[np.arange(6) != 2] > 0).any()


def test_staged_pruning_refuses_what_jax_refuses(problems):
    _, (spec_t, robot_t, p_t, th_t, sdf_t) = problems
    for kw in (dict(prune_iters=6, keep=1), dict(prune_iters=2, keep=9)):
        with pytest.raises(ValueError, match="staged pruning"):
            tms.plan_multistart(spec_t, robot_t, p_t, th_t, sdf_t,
                                tgn.OptimConfig(max_iters=6),
                                torch.Generator().manual_seed(0),
                                restarts=4, **kw)


def test_gpmp2_planner_plan_multistart_with_one_restart_matches_jax():
    """restarts=1 plans the unperturbed base only, whatever the draws."""
    from dgpmp2_tpu_torch.utils.config import load_params
    from chip_smoke import CONFIGS

    env, pp, gp, obs, _, rd = load_params(
        CONFIGS / "gpmp2_2d_params.yaml", CONFIGS / "robot_2d.yaml",
        CONFIGS / "env_2d_params.yaml")
    pp = dict(pp, total_time_step=T)
    imgs, start, goal = world(8, B, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 32))
    th0 = np.repeat(np.linspace(start[:, :2], goal[:, :2], T + 1, axis=1),
                    1, axis=0)
    th0 = np.concatenate([th0, np.repeat(((goal - start)[:, None, :2]) / 10.0,
                                         T + 1, axis=1)], -1)
    lims = {"x_lims": env["x_lims"], "y_lims": env["y_lims"]}
    optim = {"reg": 0.1, "max_iters": 5}
    got = GPMP2Planner(gp, obs, pp, lims, tr.make_robot(rd),
                       device="cpu").plan_multistart(
        start, goal, th0, sdf, optim, restarts=1, seed=3)
    want = JGPMP2Planner(gp, obs, pp, lims, jr.make_robot(rd)).plan_multistart(
        start, goal, th0, sdf, optim, restarts=1, seed=3)
    compare(got, want)
    assert got.th.dtype == F64 and not got.th.requires_grad
