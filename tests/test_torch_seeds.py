"""dgpmp2_tpu_torch.core.seeds against dgpmp2_tpu.core.seeds, and RRT*
seeds through the port's multistart against the JAX package's.

RRT* runs with ``max_iters`` binding long before ``plan_time``, so its
paths are deterministic in the seed.  The JAX package salts each row's RRT*
seed with its batch position (``seed + i``); the port takes one seed for
every row, or one per row, so the comparisons hand it ``seed + arange(B)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.core import seeds as jseeds
from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.core import seeds as tseeds

from _torch_parity import both_problems, np_, world

torch.set_num_threads(1)
LIMS = (-5.0, 5.0)
RRT = dict(plan_time=60.0, max_iters=1500)


def sdf_batch(seed, b, n=32):
    imgs, start, goal = world(seed, b, n)
    sdf = np.stack([native.sdf_2d(im > 0.75, 10.0 / n) for im in imgs])
    return sdf, start, goal


def test_path_to_traj_avg_vel_matches_jax():
    rng = np.random.default_rng(0)
    for s in (2, 5, 40):
        path = np.cumsum(rng.normal(size=(s, 2)), axis=0)
        for n in (11, 101):
            got = tseeds.path_to_traj_avg_vel(path, 10.0, n)
            want = jseeds.path_to_traj_avg_vel(path, 10.0, n)
            assert got.dtype == np.float32 and got.shape == (n, 4)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[0, :2], path[0], atol=1e-5)
            np.testing.assert_allclose(got[-1, :2], path[-1], atol=1e-5)


def test_rrt_seed_batch_matches_jax():
    """Found paths and the straight-line fallback of a problem with no path
    (its start inside an obstacle), within 1e-6."""
    sdf, start, goal = sdf_batch(0, 4)
    sdf[2] = -1.0  # no valid state: RRT* finds nothing
    kw = dict(total_time_sec=10.0, num_states=17, clearance=0.45, **RRT)
    got, found = tseeds.rrt_seed_batch(sdf, start, goal, LIMS, LIMS,
                                       seed=5 + np.arange(4), **kw)
    want, wfound = jseeds.rrt_seed_batch(sdf, start, goal, LIMS, LIMS,
                                         seed=5, **kw)
    np.testing.assert_array_equal(found, wfound)
    assert found.tolist() == [True, True, False, True]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    straight = tseeds.path_to_traj_avg_vel(
        np.stack([start[2, :2], goal[2, :2]]).astype(np.float32), 10.0, 17)
    np.testing.assert_array_equal(got[2], straight)


def test_a_problems_seed_does_not_depend_on_its_batch_position():
    sdf, start, goal = sdf_batch(1, 3)
    kw = dict(total_time_sec=10.0, num_states=17, clearance=0.45, seed=9,
              **RRT)
    fwd, _ = tseeds.rrt_seed_batch(sdf, start, goal, LIMS, LIMS, **kw)
    rev, _ = tseeds.rrt_seed_batch(sdf[::-1], start[::-1], goal[::-1], LIMS,
                                   LIMS, **kw)
    np.testing.assert_array_equal(fwd, rev[::-1])


def test_a_missing_library_raises_and_yields_no_straight_lines(monkeypatch):
    def broken():
        raise RuntimeError("native build failed (exit 1): g++ ...")

    sdf, start, goal = sdf_batch(0, 2)
    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        tseeds.rrt_seed_batch(sdf, start, goal, LIMS, LIMS, 10.0, 17, 0.45)


def test_plan_multistart_with_rrt_seeds_matches_jax():
    """RRT* seeds from each package as the pool's informed candidate beside
    the unperturbed base (restarts=1, so no draw of either package's own
    source enters), float64, 6 GN iterations: 1e-8."""
    b, t, n = 3, 16, 32
    (spec_j, robot_j, p_j, th_j, sdf_j), (spec_t, robot_t, p_t, th_t,
                                          sdf_t) = both_problems(
        seed=2, b=b, t=t, n=n)
    imgs, start, goal = world(2, b, n)
    sdf_np = np_(sdf_t).astype(np.float32)
    kw = dict(total_time_sec=10.0, num_states=t + 1, clearance=0.45, **RRT)
    seeds_t, found = tseeds.rrt_seed_batch(sdf_np, start, goal, LIMS, LIMS,
                                           seed=3 + np.arange(b), **kw)
    seeds_j, _ = jseeds.rrt_seed_batch(sdf_np, start, goal, LIMS, LIMS,
                                       seed=3, **kw)
    assert found.all()
    cfg = dict(reg=0.1, max_iters=6)
    want = jax.jit(lambda p, th, s, e: jms.plan_multistart(
        spec_j, robot_j, p, th, s, jgn.OptimConfig(engine="standard", **cfg),
        jax.random.PRNGKey(0), restarts=1, extra_seeds=e))(
        p_j, th_j, sdf_j, jnp.asarray(seeds_j, jnp.float64)[None])
    got = tms.plan_multistart(
        spec_t, robot_t, p_t, th_t, sdf_t, tgn.OptimConfig(**cfg),
        torch.Generator().manual_seed(0), restarts=1,
        extra_seeds=torch.tensor(seeds_t, dtype=torch.float64)[None])
    for name in ("th", "score"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    for name in ("k_best", "contact_free", "iters"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)
