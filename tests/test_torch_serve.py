"""dgpmp2_tpu_torch.serve against dgpmp2_tpu.serve, in float64 on the CPU,
and the port's own serving properties.

Parity: the same requests go through both packages' ``PlanningService.
plan_batch_sync`` (the JAX one jitted, the port eager) at the JAX serving
tests' sizes (T=15, 12 GN iterations, a 32² world, batches of 2-4):
trajectories and errors within 1e-8, iterations and batch fill exact, for
the static planner cold or warm with inline SDFs or the world bank, the
learned, task-space (LM) and multistart (RRT*-seeded) adapters and a 3-D
planner.  The multistart comparison sits at ``restarts=1`` with the request
at row 0: there no perturbation is drawn, and the JAX package's RRT* seed
salt (``seed + row``) is the port's one seed.

Port alone: padding invariance, refusals, the dispatcher, and the three
reference faults the port does not copy (a multistart plan, and its RRT*
pool, that depend on the request's row; a host RRT* pool built from the
inline SDF while the device plans the registered world).
"""
import asyncio
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import serve as jserve
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.planner import DiffGPMP2Planner as JPlanner
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu.robots import make_robot as j_make_robot
from dgpmp2_tpu.utils.config import load_params as j_load_params
from dgpmp2_tpu_torch import serve as tserve
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner as TPlanner
from dgpmp2_tpu_torch.robots import PointRobot2D as TPointRobot2D
from dgpmp2_tpu_torch.robots import make_robot as t_make_robot
from dgpmp2_tpu_torch.utils.config import load_params as t_load_params
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

from tests._torch_parity import F64, learned_pair, world3d

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "dgpmp2_tpu" / "configs"
TOL = 1e-8
COV = dict(qc_inv=np.eye(2), cost_sigma=0.1, epsilon_dist=0.4, k_s=0.01,
           k_g=0.01)
# RRT* stops at its iteration cap long before the wall-clock budget, so its
# paths replay.
RRT = dict(rrt_plan_time=30.0, rrt_max_iters=400)


def yaml_planners(dim="2d", t=15, iters=12):
    """The ``gpmp2_<dim>`` YAML planner at T=t, float64, in both packages."""
    out = []
    for load, make, cls, kw in (
            (j_load_params, j_make_robot, JPlanner, {"dtype": jnp.float64}),
            (t_load_params, t_make_robot, TPlanner,
             {"dtype": F64, "device": "cpu"})):
        env, pp, gp, obs, opt, rd = load(
            CFG / f"gpmp2_{dim}_params.yaml", CFG / f"robot_{dim}.yaml",
            CFG / f"env_{dim}_params.yaml")
        lims = {k: env[k] for k in ("x_lims", "y_lims", "z_lims") if k in env}
        out.append(cls(gp, obs, dict(pp, total_time_step=t),
                       dict(opt, max_iters=iters), lims, make(rd), **kw))
    return out


@pytest.fixture(scope="module")
def planners():
    return yaml_planners()


@pytest.fixture(scope="module")
def world():
    img = np.ones((32, 32))
    img[12:20, 12:20] = 0.0
    return np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(img, jnp.float64),
                                              res=10.0 / 32))


def requests(sdf, n, seed=0, world=None):
    """n float64 requests from near (-4, -4) to near (4, 4), with ``sdf``
    inline (or None) and the registered ``world`` named (or None)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = np.array([-4.0, -4.0, 0.0, 0.0]) + rng.uniform(-0.3, 0.3, 4)
        g = np.array([4.0, 4.0, 0.0, 0.0]) + rng.uniform(-0.3, 0.3, 4)
        s[2:] = g[2:] = 0.0
        out.append(tserve.PlanRequest(start=s, goal=g, sdf=sdf, world=world))
    return out


def as_jax(reqs):
    return [jserve.PlanRequest(start=r.start, goal=r.goal, sdf=r.sdf,
                               th_init=r.th_init, world=r.world)
            for r in reqs]


def assert_responses_match(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.th, w.th, rtol=tol, atol=tol)
        np.testing.assert_allclose(g.err_init, w.err_init, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(g.err_final, w.err_final, rtol=tol,
                                   atol=tol)
        assert g.iters == w.iters
        assert g.batch_fill == w.batch_fill


@pytest.fixture(scope="module")
def jax_service(planners, world):
    """One JAX service for every parity case, so that each of its four
    jitted paths compiles once."""
    svc = jserve.PlanningService(planners[0], batch_size=4)
    svc.register_world("lab", world)
    return svc


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("bank", [False, True], ids=["inline", "bank"])
def test_service_matches_jax(planners, world, jax_service, warm, bank):
    """3 requests in a batch of 4 (one pad row); warm: rows 0 and 2 seeded
    from a previous plan, row 1 by the host straight line."""
    svc = tserve.PlanningService(planners[1], batch_size=4)
    svc.register_world("lab", world)
    reqs = (requests(None, 3, world="lab") if bank
            else requests(world, 3))
    if warm:
        prev = svc.plan_batch_sync(requests(world, 3, seed=1))
        for i in (0, 2):
            reqs[i].th_init = prev[i].th
    got = svc.plan_batch_sync(reqs)
    want = jax_service.plan_batch_sync(as_jax(reqs))
    assert_responses_match(got, want)
    assert svc.stats["padded_rows"] == (2 if warm else 1)
    assert all(r.err_final < r.err_init for r in got)


def test_learned_adapter_matches_jax():
    """The campaign's bounded-eps head with random weights carried across by
    convert.py, track_best, three worlds in a batch of 4."""
    from chip_smoke import EPS_BOUNDED

    (pj, vj, _, _, sdf_j, _), (pt, vt, _, _, _, _), _ = learned_pair(
        EPS_BOUNDED, seed=2, b=3, t=10, n=32)
    sdf = np.asarray(sdf_j)
    from tests._torch_parity import world as parity_world
    _, start, goal = parity_world(2, 3, 32)
    reqs = [tserve.PlanRequest(start=start[i], goal=goal[i], sdf=sdf[i])
            for i in range(3)]
    cov = dict(COV, cost_sigma=0.05)
    want = jserve.PlanningService(
        jserve.LearnedPlanningAdapter(pj, vj, cov, dtype=jnp.float64),
        batch_size=4).plan_batch_sync(as_jax(reqs))
    got = tserve.PlanningService(
        tserve.LearnedPlanningAdapter(pt, vt, cov, dtype=F64),
        batch_size=4).plan_batch_sync(reqs)
    assert_responses_match(got, want)
    assert got[0].iters == 5


def taskspace_pair(t=15, iters=12):
    """The task-space 3-link arm (phase 8's) under LM in both packages:
    (jax adapter, port adapter)."""
    rd = {"type": "planar_arm", "link_lengths": [1.8, 1.4, 1.2],
          "spheres_per_link": 2, "sphere_radius": [0.25]}
    cov = dict(qc_inv=np.eye(3), cost_sigma=0.5, epsilon_dist=0.2,
               k_s=0.001, k_wg=0.01)
    out = []
    for graph, gn, make, serve, kw in (
            (jgraph, jgn, j_make_robot, jserve, {"dtype": jnp.float64}),
            (tgraph, tgn, t_make_robot, tserve,
             {"dtype": F64, "device": "cpu"})):
        arm = make(rd)
        spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                               nlinks=arm.nlinks, use_workspace_goal=True)
        out.append(serve.TaskSpacePlanningAdapter(
            spec, arm, cov, optim_cfg=gn.OptimConfig(
                reg=0.1, max_iters=iters, method="lm"), **kw))
    return out


def taskspace_requests(n=3, seed=3):
    """Tip targets ride in the goal state; the 96² world of the task-space
    example with its obstacle on the tip's sweep."""
    img = np.ones((96, 96))
    img[31:42, 79:90] = 0.0
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(img), res=10 / 96))
    rng = np.random.default_rng(seed)
    reqs = []
    for target in 2.6 + rng.uniform(-0.4, 0.4, (n, 2)):
        start = np.zeros(6)
        start[:3] = (-0.4, 0.0, 0.0) + rng.uniform(-0.2, 0.2, 3)
        reqs.append(tserve.PlanRequest(
            start=start, goal=np.concatenate([target, np.zeros(4)]), sdf=sdf))
    return reqs


def at_rest(adapter, reqs):
    """The requests seeded with the arm held at its start (phase 8's seed,
    the port's cold seed under a task-space goal)."""
    spec = adapter.spec
    out = []
    for r in reqs:
        s = torch.tensor(r.start[None, :spec.dof])
        th = straight_line_traj(s, s, spec.total_time_sec,
                                spec.total_time_step)[0].numpy()
        out.append(dataclasses.replace(r, th_init=th))
    return out


def test_taskspace_adapter_matches_jax():
    """Served cold by the port (seeded at rest, ``cold_seed``) against the
    JAX service handed the same seed as a warm ``th_init``: the reference
    seeds a cold row toward the target's coordinates read as joint angles
    (ROADMAP Queue 3, F1), so its cold path is not the one to hold."""
    reqs = taskspace_requests()
    ja, ta = taskspace_pair()
    want = jserve.PlanningService(ja, batch_size=4).plan_batch_sync(
        as_jax(at_rest(ta, reqs)))
    got = tserve.PlanningService(ta, batch_size=4).plan_batch_sync(reqs)
    assert_responses_match(got, want)
    for r, q in zip(got, reqs):
        assert r.err_final < r.err_init
        # The tip ends nearer its target than it starts.
        tips = ta.robot.fk(torch.tensor(r.th[[0, -1]]))[0][:, -1].numpy()
        dist = np.linalg.norm(tips - q.goal[:2], axis=-1)
        assert dist[1] < dist[0]


def multistart_pair(restarts, **kw):
    """The multistart adapter (PointRobot2D, T=12, 8 GN iterations) in both
    packages: (jax adapter, port adapter)."""
    out = []
    for graph, gn, robot, serve, dkw in (
            (jgraph, jgn, JPointRobot2D, jserve, {"dtype": jnp.float64}),
            (tgraph, tgn, TPointRobot2D, tserve,
             {"dtype": F64, "device": "cpu"})):
        out.append(serve.MultistartPlanningAdapter(
            graph.GraphSpec(total_time_step=12), robot(), COV,
            optim_cfg=gn.OptimConfig(reg=0.1, max_iters=8),
            restarts=restarts, **kw, **dkw))
    return out


def test_multistart_rrt_adapter_matches_jax(world):
    """restarts=1 (the unperturbed base) and two RRT* seeds, the request at
    row 0 of a batch of 2: JAX's seed salt is seed + 0 there."""
    ja, ta = multistart_pair(1, rrt_seeds=2, **RRT)
    req = requests(world, 1)
    want = jserve.PlanningService(ja, batch_size=2).plan_batch_sync(
        as_jax(req))
    svc = tserve.PlanningService(ta, batch_size=2)
    got = svc.plan_batch_sync(req)
    assert_responses_match(got, want)
    assert svc.stats["host_seed_time_s"] > 0.0
    # The pool's RRT* seeds found paths (not the straight-line fallback).
    pool = ta.host_extra_seeds(req[0].start[None], req[0].goal[None],
                               world[None])
    straight = tserve._straight_np(req[0].start, req[0].goal, ta.spec,
                                   np.float64)
    assert not np.allclose(pool[0, 0], straight, atol=1e-3)


def test_3d_service_matches_jax():
    """The 3-D YAML planner (T=10, 5 iterations) on 16³ voxel worlds, inline
    and through the bank, with one pad row."""
    from dgpmp2_tpu_torch.ops import sdf as tsdf

    jp, tp = yaml_planners("3d", t=10, iters=5)
    vox, start, goal = world3d(1, 3, 16)
    sdf = tsdf.sdf_from_occupancy_3d(torch.tensor(vox), res=10.0 / 16,
                                     dtype=F64).numpy()
    inline = [tserve.PlanRequest(start=start[i], goal=goal[i], sdf=sdf[i])
              for i in range(3)]
    want = jserve.PlanningService(jp, batch_size=4).plan_batch_sync(
        as_jax(inline))
    svc = tserve.PlanningService(tp, batch_size=4)
    for i in range(3):
        svc.register_world(f"vox{i}", sdf[i])
    assert_responses_match(svc.plan_batch_sync(inline), want)
    named = [tserve.PlanRequest(start=start[i], goal=goal[i],
                                world=f"vox{i}") for i in range(3)]
    assert_responses_match(svc.plan_batch_sync(named), want)
    assert tuple(svc._banks[svc.device].shape) == (3, 16, 16, 16)


# -- the port alone -----------------------------------------------------------

def direct_plan(planner, reqs):
    start = torch.tensor(np.stack([r.start for r in reqs]), dtype=F64)
    goal = torch.tensor(np.stack([r.goal for r in reqs]), dtype=F64)
    sdf = torch.tensor(np.stack([r.sdf for r in reqs]), dtype=F64)
    th0 = straight_line_traj(start[:, :2], goal[:, :2],
                             planner.spec.total_time_sec,
                             planner.spec.total_time_step)
    return planner.plan(th0, start, goal, sdf).th.numpy()


def test_padded_partial_batch_matches_direct(planners, world):
    svc = tserve.PlanningService(planners[1], batch_size=4)
    reqs = requests(world, 3)
    out = svc.plan_batch_sync(reqs)
    for r, d in zip(out, direct_plan(planners[1], reqs)):
        np.testing.assert_allclose(r.th, d, rtol=0, atol=1e-12)
        assert r.batch_fill == pytest.approx(0.75)
    assert (svc.stats["padded_rows"], svc.stats["batches"]) == (1, 1)


def test_warm_start_seed_is_used_and_reregistering_replaces(planners, world):
    svc = tserve.PlanningService(planners[1], batch_size=2)
    svc.register_world("lab", world)
    reqs = requests(None, 2, world="lab")
    cold = svc.plan_batch_sync(reqs)
    for r, c in zip(reqs, cold):
        r.th_init = c.th
    for c, w in zip(cold, svc.plan_batch_sync(reqs)):
        assert w.err_init == pytest.approx(c.err_final, rel=1e-9)
        assert w.err_final <= c.err_final * (1 + 1e-9)
    svc.register_world("lab", world + 1.0)
    assert svc._banks[svc.device].shape[0] == 1
    moved = svc.plan_batch_sync([tserve.PlanRequest(
        start=reqs[0].start, goal=reqs[0].goal, world="lab")])[0]
    assert not np.allclose(moved.th, cold[0].th)


@pytest.mark.parametrize("case", ["oversize", "unregistered", "no_world"])
def test_refusals_match_jax(planners, world, case):
    """Each package raises the same exception type, before any plan."""
    bad = {"oversize": requests(world, 3),
           "unregistered": requests(None, 1, world="nope"),
           "no_world": requests(None, 1)}[case]
    raised = []
    for svc, reqs in (
            (jserve.PlanningService(planners[0], batch_size=2), as_jax(bad)),
            (tserve.PlanningService(planners[1], batch_size=2), bad)):
        with pytest.raises((KeyError, ValueError)) as info:
            svc.plan_batch_sync(reqs)
        raised.append(info.type)
        assert svc.stats["batches"] == 0
    assert raised[0] is raised[1]


def test_submit_before_start_raises(planners, world):
    svc = tserve.PlanningService(planners[1], batch_size=2)
    with pytest.raises(RuntimeError, match="not started"):
        asyncio.run(svc.submit(requests(world, 1)[0]))


def test_async_coalesces_concurrent_requests(planners, world):
    svc = tserve.PlanningService(planners[1], batch_size=4, window_ms=200.0)
    reqs = requests(world, 6)

    async def run():
        await svc.start()
        try:
            return await asyncio.gather(*(svc.submit(r) for r in reqs))
        finally:
            await svc.stop()

    out = asyncio.run(run())
    for r, d in zip(out, direct_plan(planners[1], reqs)):
        np.testing.assert_allclose(r.th, d, rtol=0, atol=1e-12)
        assert r.latency_s > 0
    assert (svc.stats["batches"], svc.stats["requests"]) == (2, 6)
    assert svc.stats["padded_rows"] == 2


def test_dispatcher_passes_exceptions_to_every_waiter(planners, world):
    svc = tserve.PlanningService(planners[1], batch_size=4, window_ms=5.0)

    async def run():
        await svc.start()
        try:
            bad = requests(None, 3, world="never-registered")
            got = await asyncio.gather(*(svc.submit(r) for r in bad),
                                       return_exceptions=True)
            assert all(isinstance(g, KeyError) for g in got)
            ok = await svc.submit(requests(world, 1)[0])
            assert np.isfinite(ok.th).all()
        finally:
            await svc.stop()

    asyncio.run(run())


def test_dispatch_runs_without_grad_in_the_executor_thread(planners, world):
    """Grad mode is per thread: a dispatch in the executor must not build an
    autograd graph even where the caller's thread has grad on."""
    seen = []
    planner = planners[1]

    class Spy:
        spec, dtype, device = planner.spec, planner.dtype, planner.device

        def plan(self, *args):
            seen.append(torch.is_grad_enabled())
            return planner.plan(*args)

    svc = tserve.PlanningService(Spy(), batch_size=2)

    async def run():
        await svc.start()
        try:
            return await svc.submit(requests(world, 1)[0])
        finally:
            await svc.stop()

    assert torch.is_grad_enabled()
    asyncio.run(run())
    svc.plan_batch_sync(requests(world, 1))
    assert seen == [False, False]


def test_multistart_plan_does_not_depend_on_the_row(world):
    """Repaired fault: the same request at rows 0 and 3 of one dispatch, and
    alone in another, gets the same plan (the JAX adapter draws its
    perturbations per row: here a perturbed candidate wins, so draws per
    row would part the two rows' plans)."""
    _, ta = multistart_pair(8)
    svc = tserve.PlanningService(ta, batch_size=4)
    req = requests(world, 1)[0]
    others = requests(world, 2, seed=5)
    out = svc.plan_batch_sync([req] + others + [req])
    alone = svc.plan_batch_sync([req])[0]
    np.testing.assert_array_equal(out[0].th, out[3].th)
    np.testing.assert_array_equal(out[0].th, alone.th)
    assert out[0].err_final == out[3].err_final == alone.err_final
    assert out[0].err_final < out[0].err_init


def test_rrt_pool_does_not_depend_on_the_row(world):
    """Repaired fault: a row's RRT* seeds are the same at every place in the
    batch (the JAX package searches row i with seed + i)."""
    _, ta = multistart_pair(1, rrt_seeds=2, **RRT)
    reqs = requests(world, 3)
    start = np.stack([r.start for r in reqs])
    goal = np.stack([r.goal for r in reqs])
    sdf = np.stack([world] * 3)
    fwd = ta.host_extra_seeds(start, goal, sdf)
    rev = ta.host_extra_seeds(start[::-1], goal[::-1], sdf)
    assert fwd.shape == (3, 2, 13, 4)
    np.testing.assert_array_equal(fwd, rev[::-1])


def test_rrt_pool_comes_from_the_world_the_device_plans(world, monkeypatch):
    """Repaired fault: a request with an inline SDF that also names a
    registered world is planned in the world on the device, and its host
    RRT* pool comes from that world too (the JAX package takes the inline
    SDF for the pool)."""
    _, ta = multistart_pair(1, rrt_seeds=1, **RRT)
    svc = tserve.PlanningService(ta, batch_size=2)
    svc.register_world("lab", world)
    seen = []
    host_seeds = svc._host_seeds
    monkeypatch.setattr(svc, "_host_seeds",
                        lambda s, g, sdf: seen.append(sdf) or host_seeds(
                            s, g, sdf))
    inline = np.full_like(world, 5.0)  # a free world
    both = requests(inline, 1, world="lab")
    named = requests(None, 1, world="lab")
    a, b = svc.plan_batch_sync(both)[0], svc.plan_batch_sync(named)[0]
    np.testing.assert_array_equal(seen[0], world[None])
    np.testing.assert_array_equal(a.th, b.th)


def test_cold_taskspace_request_equals_the_warm_one_at_rest():
    """Repaired fault (F1): a cold task-space request is seeded with the arm
    held at its start, so it equals the request seeded at rest bit for bit;
    in a warm batch, a row without a seed gets the same seed on the host."""
    _, ta = taskspace_pair(t=10, iters=6)
    reqs = taskspace_requests(n=2, seed=8)
    rested = at_rest(ta, reqs)
    svc = tserve.PlanningService(ta, batch_size=2)
    cold = svc.plan_batch_sync(reqs)
    warm = svc.plan_batch_sync(rested)
    mixed = svc.plan_batch_sync([reqs[0], rested[1]])
    for a, b, c in zip(cold, warm, mixed):
        np.testing.assert_array_equal(a.th, b.th)
        np.testing.assert_array_equal(a.th, c.th)
        assert a.err_init == b.err_init == c.err_init
        assert a.err_final == b.err_final < a.err_init
    seed = ta.cold_seed(torch.tensor(np.stack([r.start for r in reqs])),
                        None)
    np.testing.assert_array_equal(seed.numpy(),
                                  np.stack([r.th_init for r in rested]))
    assert torch.equal(seed[:, 0], seed[:, -1])


MESH8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("mode", ["bank", "inline", "warm"])
def test_sharded_service_matches_unsharded(planners, world, mode):
    """A mesh of 8 repeated CPU devices (JAX's 8 virtual CPU devices) plans
    one row per shard; every response equals the unsharded service's to
    1e-12 (tests/test_serve.py:290-310), 5 requests padded to 8."""
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(MESH8)
    plain = tserve.PlanningService(planners[1], batch_size=8)
    sharded = tserve.PlanningService(planners[1], batch_size=8, mesh=mesh)
    # A world of its own for each request: the obstacle moved along x.
    worlds = [np.roll(world, 3 * i, axis=1) for i in range(5)]
    for svc in (plain, sharded):
        for i, w in enumerate(worlds):
            svc.register_world(f"w{i}", w)
    reqs = requests(None, 5)
    for i, r in enumerate(reqs):
        if mode == "bank":
            r.world = f"w{i}"
        else:
            r.sdf = worlds[i]
    if mode == "warm":
        for r, c in zip(reqs, plain.plan_batch_sync(reqs)):
            r.th_init = c.th
    a, b = plain.plan_batch_sync(reqs), sharded.plan_batch_sync(reqs)
    assert_responses_match(b, a, tol=1e-12)
    assert len(sharded._shards) == 8 and sharded._banks.keys() == {
        torch.device("cpu")}
    assert sharded.stats["batches"] == 1


def test_sharded_service_refuses_a_batch_the_mesh_does_not_divide(planners):
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        tserve.PlanningService(planners[1], batch_size=6,
                               mesh=make_mesh(MESH8))
    with pytest.raises(ValueError, match="mesh size 2"):
        tserve.PlanningService(planners[1], batch_size=255,
                               mesh=make_mesh(MESH8[:2]))


def test_sharded_multistart_splits_one_host_pool(world, monkeypatch):
    """The RRT*-seeded multistart adapter on a mesh of 2: one host pool
    for the whole batch, split with it; the plans equal the unsharded
    service's."""
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    _, ta = multistart_pair(2, rrt_seeds=1, **RRT)
    plain = tserve.PlanningService(ta, batch_size=4)
    sharded = tserve.PlanningService(ta, batch_size=4,
                                     mesh=make_mesh(MESH8[:2]))
    calls = []
    pool = sharded._host_seeds
    monkeypatch.setattr(sharded, "_host_seeds",
                        lambda s, g, sdf: calls.append(len(s)) or pool(
                            s, g, sdf))
    reqs = requests(world, 3)
    assert_responses_match(sharded.plan_batch_sync(reqs),
                           plain.plan_batch_sync(reqs), tol=1e-12)
    assert calls == [3]


@pytest.mark.parametrize("kind", ["learned", "multistart"])
def test_a_mesh_of_two_devices_plans_on_planner_replicas(world, kind):
    """``cpu`` and ``cpu:0`` are two entries the service tells apart: the
    second shard plans on a replica of the adapter (its modules copied, its
    tensors and wrapped planner moved) with a bank of its own, and the
    responses equal the unsharded service's to 1e-12."""
    from chip_smoke import EPS_BOUNDED
    from dgpmp2_tpu_torch.parallel.sharding import make_mesh

    if kind == "learned":
        _, (pt, vt, *_), _ = learned_pair(EPS_BOUNDED, seed=2, b=3, t=10,
                                          n=32)
        adapter = tserve.LearnedPlanningAdapter(
            pt, vt, dict(COV, cost_sigma=0.05), dtype=F64)
    else:
        _, adapter = multistart_pair(4)
    second = torch.device("cpu", 0)
    plain = tserve.PlanningService(adapter, batch_size=4)
    sharded = tserve.PlanningService(adapter, batch_size=4,
                                     mesh=make_mesh(["cpu", second]))
    worlds = [np.roll(world, 5 * i, axis=0) for i in range(3)]
    for svc in (plain, sharded):
        for i, w in enumerate(worlds):
            svc.register_world(f"w{i}", w)
    reqs = requests(None, 3)
    for i, r in enumerate(reqs):
        r.world = f"w{i}"
    assert_responses_match(sharded.plan_batch_sync(reqs),
                           plain.plan_batch_sync(reqs), tol=1e-12)
    (d0, p0), (d1, p1) = sharded._shards
    assert p0 is adapter and p1 is not adapter and p1.device == second
    assert set(sharded._banks) == {torch.device("cpu"), second}
    if kind == "learned":
        assert p1.lplanner is not pt and p1.lplanner.device == second
        assert p1.variables is not vt
        for a, b in zip(p1.variables.parameters(), vt.parameters()):
            assert torch.equal(a, b)


def test_serving_modules_import_without_jax():
    code = ("import sys, dgpmp2_tpu_torch.serve\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'dgpmp2_tpu') "
            "for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bench_serve_torch_runs_on_the_cpu():
    """tools/bench_serve_torch.py at a tiny size on the CPU: one row per
    level with plans/s, p50 and (on fewer than 100 responses) the largest
    latency in place of a p99, the stats line, and no JAX imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['bench_serve_torch.py', '--device', 'cpu', "
            "'--batch', '4', '--t', '8', '--iters', '3', '--levels', '1', "
            "'4', '--rounds', '1']\n"
            "runpy.run_path('tools/bench_serve_torch.py', "
            "run_name='__main__')\n"
            "assert not any(m.split('.')[0] in ('jax', 'dgpmp2_tpu') "
            "for m in sys.modules)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [line for line in proc.stdout.splitlines()
            if line.startswith("[CPU] concurrency")]
    assert [int(r.split()[2].rstrip(":")) for r in rows] == [1, 4]
    for r in rows:
        assert "plans/s" in r and "p50" in r and "p99 n/a" in r
        assert "max" in r
    # warm-up pass of 4 (one batch), level 1 (one), level 4 (one)
    assert "{'batches': 3, 'padded_rows': 3, 'requests': 9}" in proc.stdout


def test_bench_level_row_states_a_p99_only_on_100_latencies():
    """A level's p99 needs 100 latencies; below that the row gives the
    largest one, which is all such a p99 would be."""
    import importlib.util
    from types import SimpleNamespace

    spec = importlib.util.spec_from_file_location(
        "bench_serve_torch", ROOT / "tools" / "bench_serve_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    def responses(n):
        return [SimpleNamespace(latency_s=(i + 1) / 1e3, err_final=0.0)
                for i in range(n)]

    few = bench.level_row(1, 1.0, responses(3))
    assert (few["n"], few["p50_ms"], few["p99_ms"], few["max_ms"]) == (
        3, 2.0, None, 3.0)
    assert "p99 n/a" in bench.row_line("CPU", few)
    many = bench.level_row(1, 2.0, responses(300))
    assert (many["p50_ms"], many["p99_ms"], many["max_ms"]) == (
        151.0, 298.0, 300.0)
    assert many["plans_per_s"] == 150.0
    assert "p99   298.0 ms" in bench.row_line("CPU", many)
