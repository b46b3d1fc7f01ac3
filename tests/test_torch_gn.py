"""dgpmp2_tpu_torch Gauss-Newton / LM engine against dgpmp2_tpu.

Float64 on the CPU over at most 5 iterations (long GN runs are chaotic and
are never compared); the JAX side runs its standard engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu_torch.core import gn as tgn

from _torch_parity import F64, both_problems, np_

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problems():
    return both_problems(seed=1, b=4, t=16, n=32)


def test_gn_step_matches_jax(problems):
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    want = jgn.gn_step(spec_j, robot_j, p_j, th_j, sdf_j, 0.1)
    got = tgn.gn_step(spec_t, robot_t, p_t, th_t, sdf_t, 0.1)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-9, atol=1e-9)
    lam = np.array([1e-3, 1e-2, 1e-1, 1.0])
    want = jgn.gn_step(spec_j, robot_j, p_j, th_j, sdf_j, jnp.asarray(lam),
                       trust_region=True)
    got = tgn.gn_step(spec_t, robot_t, p_t, th_t, sdf_t, torch.tensor(lam),
                      trust_region=True)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
def test_plan_matches_jax(problems, method):
    """5 iterations with track_best: th, both error traces, iterations and
    the best-trajectory record at 1e-8.  The LM run starts from a tiny
    lambda, so it rejects steps."""
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    kw = dict(method=method, reg=0.1, max_iters=5, tol_delta=1e-3,
              lm_lambda_init=1e-6)
    r_j = jgn.plan(spec_j, robot_j, p_j, th_j, sdf_j,
                   jgn.OptimConfig(engine="standard", **kw), track_best=True)
    r_t = tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t, tgn.OptimConfig(**kw),
                   track_best=True)
    for name in ("th", "err_init", "err_final", "err_per_iter",
                 "err_ext_per_iter", "best_th"):
        np.testing.assert_allclose(np_(getattr(r_t, name)),
                                   np_(getattr(r_j, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(np_(r_t.iters), np_(r_j.iters))
    np.testing.assert_array_equal(np_(r_t.best_valid), np_(r_j.best_valid))
    if method == "lm":
        errs = np.concatenate([np_(r_t.err_init)[None],
                               np_(r_t.err_per_iter)])
        assert (np.diff(errs, axis=0) == 0).any(), "no LM step was rejected"


def test_plan_gradient_matches_jax(problems):
    """d sum(plan(th_init).th) / d th_init over 3 GN iterations: 1e-6."""
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = problems
    kw = dict(reg=0.1, max_iters=3, tol_delta=0.0)
    cfg_j = jgn.OptimConfig(engine="standard", **kw)
    g_j = jax.jit(jax.grad(lambda th: jnp.sum(
        jgn.plan(spec_j, robot_j, p_j, th, sdf_j, cfg_j).th)))(th_j)
    th = th_t.clone().requires_grad_(True)
    out = tgn.plan(spec_t, robot_t, p_t, th, sdf_t, tgn.OptimConfig(**kw))
    out.th.sum().backward()
    assert not out.err_per_iter.requires_grad
    assert out.err_ext_per_iter.requires_grad
    np.testing.assert_allclose(np_(th.grad), np_(g_j),
                               rtol=1e-6, atol=1e-6 * np.abs(np_(g_j)).max())


def test_damped_system_matches_jax():
    rng = np.random.default_rng(2)
    diag = rng.standard_normal((3, 5, 4, 4))
    delta = rng.uniform(size=3)
    for tr in (False, True):
        got = tgn.damped_system(torch.tensor(diag), None, None,
                                torch.tensor(delta), trust_region=tr)[0]
        want = jgn.damped_system(jnp.asarray(diag), None, None,
                                 jnp.asarray(delta), trust_region=tr)[0]
        np.testing.assert_allclose(np_(got), np_(want), atol=1e-14)


@pytest.mark.parametrize("engine", ["stream", "df32", "bogus"])
def test_engines_other_than_standard_raise(problems, engine):
    """An unknown engine raises, and so does df32 in a float64 plan; the
    stream engine plans as the standard one does."""
    _, (spec_t, robot_t, p_t, th_t, sdf_t) = problems
    if engine == "stream":
        cfg = dict(max_iters=3, tol_delta=0.0)
        got = tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t,
                       tgn.OptimConfig(engine=engine, **cfg))
        want = tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t,
                        tgn.OptimConfig(engine="standard", **cfg))
        np.testing.assert_allclose(np_(got.th), np_(want.th), rtol=1e-10,
                                   atol=1e-10)
    else:
        with pytest.raises(ValueError, match="engine|df32"):
            tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t,
                     tgn.OptimConfig(engine=engine))
    assert tgn.resolve_engine("auto") == tgn.resolve_engine("standard")
    with pytest.raises(ValueError, match="method"):
        tgn.plan(spec_t, robot_t, p_t, th_t, sdf_t,
                 tgn.OptimConfig(method="newton"))
    assert th_t.dtype == F64
