"""``core.gn.plan``'s captured loop: when it engages, what its key tells
apart, and that a replay answers as the eager loop does.

On the CPU (Tier-1): the engagement decision, the key, the counters and the
``dgpmp2.plan`` span's ``graph`` argument, with the plan's device type set
to the CPU and the CUDA graph replaced by a fake that runs the captured
call again on the static buffers.  Marked ``cuda`` (they skip without a
card): replays bit-equal to the eager plan at the benchmark cell's problem,
on the card.  On the card, with no JAX there:

    python -m pytest tests/test_torch_plan_graph.py --noconftest -m cuda
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.ops.cuda import btd_stream
from dgpmp2_tpu_torch.utils import profiling
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

from _torch_graph import fake_card  # noqa: F401 - a fixture

FIELDS = gn.PlanResult._fields


def _problem(b, t=8, n=16, dev="cpu", dtype=torch.float64, seed=0):
    """(spec, robot, params, th0, sdf) of ``b`` 2-D problems: one box in
    the middle of each n x n world, start and goal on either side."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((b, n, n))
    for i, (r, c) in enumerate(rng.integers(n // 3, n // 2, (b, 2))):
        occ[i, r:r + n // 4, c:c + n // 4] = 1.0
    start = np.zeros((b, 4))
    goal = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.0, -3.0, (b, 2))
    goal[:, :2] = rng.uniform(3.0, 4.0, (b, 2))
    spec = graph.GraphSpec(total_time_step=t)
    robot = PointRobot2D()
    sdf = sdf_ops.sdf_from_occupancy(torch.tensor(occ, device=dev),
                                     res=10.0 / n, dtype=dtype)
    start_t = torch.tensor(start, dtype=dtype, device=dev)
    goal_t = torch.tensor(goal, dtype=dtype, device=dev)
    params = graph.default_params(spec, robot, start_t, goal_t,
                                  qc_inv=np.eye(2), cost_sigma=0.05,
                                  epsilon_dist=0.4, k_s=0.01, k_g=0.01,
                                  dtype=dtype)
    th0 = straight_line_traj(start_t[:, :2], goal_t[:, :2],
                             spec.total_time_sec, t)
    return spec, robot, params, th0, sdf


def _cfg(**kw):
    return gn.OptimConfig(**{"max_iters": 4, "tol_delta": 0.0, **kw})


def _key(spec, robot, params, th0, sdf, cfg, params_fix=None,
         track_best=False):
    return gn._graph_key(spec, robot, params,
                         params if params_fix is None else params_fix, th0,
                         sdf, cfg, track_best,
                         gn.resolve_engine(cfg.engine))


def _same(a: gn.PlanResult, b: gn.PlanResult) -> bool:
    """Every output of two plans bit for bit (``None`` where the other's
    is)."""
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None):
            return False
        if x is not None and not (x.dtype == y.dtype and x.shape == y.shape
                                  and torch.equal(x, y)):
            return False
    return True


# -- on the CPU: the decision, the key, the counters ---------------------------

@contextlib.contextmanager
def _setting(setter, value, old):
    """``setter(value)`` inside the block, ``setter(old)`` after it."""
    setter(value)
    try:
        yield
    finally:
        setter(old)


def _lookup_method(method):
    """The 2-D lookup engine set to ``method`` inside the block."""
    return _setting(sdf_ops.set_lookup_method, method,
                    sdf_ops._LOOKUP_METHOD)


def test_the_decision_declines_every_plan_on_the_cpu():
    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg()
    assert _key(spec, robot, params, th0, sdf, cfg) is None  # CPU tensors
    gn._reset_graphs()
    gn.plan(spec, robot, params, th0, sdf, cfg)
    gn.plan(spec, robot, params, th0, sdf, cfg)
    assert gn.graph_counts == {"eager": 2, "captures": 0,
                                        "replays": 0, "evictions": 0}
    gn._reset_graphs()


def test_the_decision_declines_a_leaf_requiring_grad_under_grad(fake_card):
    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg()
    assert _key(spec, robot, params, th0, sdf, cfg) is not None
    q = params.q_inv.clone().requires_grad_(True)
    grad_params = dataclasses.replace(params, q_inv=q)
    assert _key(spec, robot, grad_params, th0, sdf, cfg) is None
    with torch.no_grad():
        assert _key(spec, robot, grad_params, th0, sdf, cfg) is not None
    # A first sighting runs eagerly; a requires-grad plan stays eager with
    # the gradients of the eager loop.
    grads = []
    for _ in range(3):
        q = params.q_inv.clone().requires_grad_(True)
        out = gn.plan(spec, robot, dataclasses.replace(params, q_inv=q), th0,
                      sdf, cfg)
        out.err_ext_per_iter.sum().backward()
        grads.append(q.grad)
    q = params.q_inv.clone().requires_grad_(True)
    ref = gn._eager_plan(spec, robot, dataclasses.replace(params, q_inv=q),
                         th0, sdf, cfg)
    ref.err_ext_per_iter.sum().backward()
    assert all(torch.equal(g, q.grad) for g in grads)
    assert gn.graph_counts["captures"] == 0
    assert gn.graph_counts["eager"] == 4


def test_the_decision_declines_an_input_on_another_device_or_empty(
        fake_card, monkeypatch):
    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg()
    assert _key(spec, robot, params, th0[:0], sdf[:0], cfg) is None
    monkeypatch.setattr(gn, "_GRAPH_DEVICE", "meta")
    assert _key(spec, robot, params, th0, sdf, cfg) is None


@pytest.mark.parametrize("change", [
    "B", "T", "D", "dtype", "engine", "method", "max_iters", "track_best",
    "none_field", "alias", "stride", "lookup", "rows_plan", "oob_mode"])
def test_the_key_separates(fake_card, change):
    """Each of these gives another key than the base plan's; a setting is
    changed through its setter, which marks a new generation."""
    spec, robot, params, th0, sdf = _problem(3)
    cfg = _cfg()
    base = _key(spec, robot, params, th0, sdf, cfg)
    assert base is not None
    assert _key(spec, robot, params, th0, sdf, _cfg()) == base
    kw = dict(params_fix=None, track_best=False)
    if change == "B":
        spec, robot, params, th0, sdf = _problem(4)
    elif change == "T":
        spec, robot, params, th0, sdf = _problem(3, t=9)
    elif change == "D":
        spec = dataclasses.replace(spec, state_dim=6, dof=3)
        th0 = torch.zeros(3, 9, 6, dtype=th0.dtype)
    elif change == "dtype":
        spec, robot, params, th0, sdf = _problem(3, dtype=torch.float32)
    elif change == "engine":
        cfg = _cfg(engine="stream")
    elif change == "method":
        cfg = _cfg(method="lm")
    elif change == "max_iters":
        cfg = _cfg(max_iters=5)
    elif change == "track_best":
        kw["track_best"] = True
    elif change == "none_field":
        params = dataclasses.replace(
            params, dyn_inv=torch.ones(3, 9, dtype=th0.dtype))
    elif change == "alias":
        kw["params_fix"] = dataclasses.replace(params,
                                               q_inv=params.q_inv.clone())
    elif change == "stride":
        th0 = th0.transpose(1, 2).contiguous().transpose(1, 2)
    settings = contextlib.nullcontext()
    if change == "lookup":
        settings = _lookup_method("pallas_v3_1")
    elif change == "rows_plan":
        settings = _setting(lambda caps: btd_stream.set_rows_plan(**caps),
                            {"stages": 2}, btd_stream._ROWS_CAPS)
    elif change == "oob_mode":
        settings = _setting(sdf_ops.set_oob_mode, "reference",
                            sdf_ops._OOB_MODE)
    with settings:
        key = _key(spec, robot, params, th0, sdf, cfg, **kw)
    assert key is not None and key != base


def test_a_self_overlapping_input_runs_eagerly(fake_card):
    spec, robot, params, th0, sdf = _problem(2)
    flat = torch.zeros(20, dtype=sdf.dtype)
    odd = flat.as_strided((2, 4, 4), (1, 2, 1))
    assert _key(spec, robot, params, th0, odd, _cfg()) is None
    # A broadcast input is no overlap: its copy stays broadcast.
    assert params.q_inv.stride()[0] == 0
    assert _key(spec, robot, params, th0, sdf, _cfg()) is not None


@pytest.mark.parametrize("track_best", [False, True])
@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
def test_the_captured_path_answers_as_the_eager_loop(fake_card, method,
                                                     track_best):
    """Eager, capture, replay: every output bit-equal to the eager loop's,
    the counters and the span read what happened, and a replay's outputs
    survive the next replay."""
    spec, robot, params, th0, sdf = _problem(3)
    cfg = _cfg(method=method)
    ref = gn._eager_plan(spec, robot, params, th0, sdf, cfg,
                         track_best=track_best)
    gn._reset_graphs()
    outs = [gn.plan(spec, robot, params, th0, sdf, cfg,
                    track_best=track_best) for _ in range(4)]
    assert all(_same(o, ref) for o in outs)
    assert gn.graph_counts == {"eager": 1, "captures": 1,
                                        "replays": 2, "evictions": 0}
    # New inputs replay to the eager answers of those inputs, and the
    # answers held from before are not overwritten.
    spec2, robot2, params2, th2, sdf2 = _problem(3, seed=5)
    ref2 = gn._eager_plan(spec2, robot2, params2, th2, sdf2, cfg,
                          track_best=track_best)
    new = gn.plan(spec2, robot2, params2, th2, sdf2, cfg,
                  track_best=track_best)
    assert gn.graph_counts["replays"] == 3
    assert _same(new, ref2) and not torch.equal(new.th, ref.th)
    assert all(_same(o, ref) for o in outs)


def test_the_span_names_the_path(fake_card):
    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg()
    paths = []
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                record_shapes=True) as prof:
            gn.plan(spec, robot, params, th0, sdf, cfg)
        plan = [e for e in prof.events() if e.name == "dgpmp2.plan"]
        stages = [e for e in prof.events() if e.name == "dgpmp2.solve"]
        assert len(plan) == 1
        paths.append((plan[0].kwinputs["graph"], len(stages)))
    # The fake "replay" runs Python, so its stage spans open; the card's
    # graph opens none (the card test below).
    assert [p for p, _ in paths] == ["eager", "capture", "replay"]
    assert paths[0][1] == cfg.max_iters


def test_the_counters_count_each_replay_and_not_the_capture(fake_card,
                                                            monkeypatch):
    """Kernel wrappers counting on the CPU: of n plans of one key the
    wrappers count the eager one's launches; the n − 1 replays (the
    capture's first included) add the eager plan's launches to
    ``gn.graph_launches`` each, and the capture adds nothing."""
    from _torch_examples import count_plain_launches

    count_plain_launches(monkeypatch)
    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg()
    before = profiling.counters()
    gn._eager_plan(spec, robot, params, th0, sdf, cfg)
    mid = profiling.counters()
    one = {k: mid[k] - before[k] for k in mid}
    assert one["btd_solve"] == cfg.max_iters
    assert one["sdf_lookup"] == cfg.max_iters + 1
    gn._reset_graphs()
    n = 4
    for _ in range(n):
        gn.plan(spec, robot, params, th0, sdf, cfg)
    after = profiling.counters()
    assert {k: after[k] - mid[k] for k in after} == one
    assert dict(gn.graph_launches) == {k: (n - 1) * v
                                       for k, v in one.items() if v}
    assert gn.graph_counts["replays"] == n - 2


def test_the_cache_stays_bounded(fake_card):
    cfg = _cfg(max_iters=1)
    for b in range(1, gn.GRAPH_CACHE + 3):
        problem = _problem(b)
        for _ in range(2):
            gn.plan(*problem, cfg)
    assert len(gn._graphs) == gn.GRAPH_CACHE
    counts = gn.graph_counts
    assert counts["captures"] == gn.GRAPH_CACHE + 2
    assert counts["evictions"] == 2
    # An evicted key is forgotten: its next plan runs eagerly as a first
    # sighting, and the one after captures it again.
    eager = gn.graph_counts["eager"]
    gn.plan(*_problem(1), cfg)
    assert gn.graph_counts["eager"] == eager + 1
    assert gn.graph_counts["captures"] == gn.GRAPH_CACHE + 2
    gn.plan(*_problem(1), cfg)
    assert gn.graph_counts["captures"] == gn.GRAPH_CACHE + 3
    assert len(gn._graphs) == gn.GRAPH_CACHE


def test_staged_multistart_makes_two_keys_and_replays_both(fake_card):
    """Staged multistart plans two keys a call (phase 1: every seed for
    ``prune_iters``; phase 2: the survivors for the rest): its third call
    replays both, answering as its first, eager one did.  A service
    shards one such planner per card, so over four cards it cycles through
    eight keys, :data:`gn.GRAPH_CACHE`."""
    from dgpmp2_tpu_torch.core import multistart

    spec, robot, params, th0, sdf = _problem(2)
    cfg = _cfg(max_iters=4)
    outs = [multistart.plan_multistart(
        spec, robot, params, th0, sdf, cfg, torch.Generator().manual_seed(0),
        restarts=3, prune_iters=2, keep=2) for _ in range(3)]
    assert len(gn._graphs) == 2 and gn.GRAPH_CACHE >= 4 * 2
    assert gn.graph_counts == {"eager": 2, "captures": 2, "replays": 2,
                               "evictions": 0}
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))


def test_threads_share_one_graph_and_lose_no_count(fake_card):
    """More threads than cores plan one key at once, with a short switch
    interval: one capture, every plan counted once, every answer the eager
    loop's."""
    import os
    import sys
    import threading

    problem = _problem(2, t=4)
    cfg = _cfg(max_iters=1)
    ref = gn._eager_plan(*problem, cfg)
    gn._reset_graphs()
    n_threads, n_plans = 2 * (os.cpu_count() or 2), 3
    outs, errors = [], []

    def work():
        try:
            for _ in range(n_plans):
                outs.append(gn.plan(*problem, cfg))
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    counts = gn.graph_counts
    assert counts["captures"] == 1
    assert counts["eager"] + counts["captures"] + counts["replays"] == \
        n_threads * n_plans == len(outs)
    assert all(_same(o, ref) for o in outs)


@pytest.mark.parametrize("setter", [
    "set_lookup_method", "set_lookup3d_method", "set_oob_mode",
    "set_rows_plan", "set_producers"])
def test_every_setter_marks_a_new_generation(fake_card, setter, monkeypatch):
    """Each process-wide setting's setter marks a new generation, so a
    plan after it runs eagerly (a new key) where it would have replayed."""
    import types

    from dgpmp2_tpu_torch.ops.cuda import _build
    from dgpmp2_tpu_torch.utils import settings

    calls = {
        "set_lookup_method": lambda: _lookup_method("gather"),
        "set_lookup3d_method": lambda: _setting(
            sdf_ops.set_lookup3d_method, "gather",
            sdf_ops._LOOKUP3D_METHOD),
        "set_oob_mode": lambda: _setting(sdf_ops.set_oob_mode, "intended",
                                         sdf_ops._OOB_MODE),
        "set_rows_plan": lambda: _setting(
            lambda caps: btd_stream.set_rows_plan(**caps), {},
            btd_stream._ROWS_CAPS),
        "set_producers": lambda: _setting(btd_stream.set_producers, 3, 0),
    }
    # The producer cap is held by the kernel library; a stand-in holds it
    # here.
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        dgpmp2_btd_stream_set_producers=lambda n: 0))
    problem = _problem(2)
    cfg = _cfg(max_iters=1)
    for _ in range(2):
        gn.plan(*problem, cfg)
    generation = settings.generation
    with calls[setter]():  # the setting set to what it was: still a change
        assert settings.generation == generation + 1
        gn.plan(*problem, cfg)
    assert gn.graph_counts == {"eager": 2, "captures": 1, "replays": 0,
                               "evictions": 0}


def test_counters_and_add_counts_round_trip(monkeypatch):
    from dgpmp2_tpu_torch.ops.cuda import btd_solve, sdf_lookup_limbs

    monkeypatch.setattr(btd_solve, "regime_launches",
                        dict(btd_solve.regime_launches))
    for m in (btd_solve, sdf_lookup_limbs):
        monkeypatch.setattr(m, "launches", m.launches)
    monkeypatch.setattr(sdf_lookup_limbs, "splits", sdf_lookup_limbs.splits)
    c = profiling.counters()
    assert set(profiling.launch_counts()) < set(c)
    assert {"btd_solve.lane", "btd_solve.wide", "sdf_lookup_limbs.splits"} \
        <= set(c)
    delta = {"btd_solve": 3, "btd_solve.lane": 3, "sdf_lookup_limbs.splits": 1}
    profiling.add_counts(delta)
    after = profiling.counters()
    assert {k: after[k] - c[k] for k in c if after[k] != c[k]} == delta
    profiling.add_counts({k: -v for k, v in delta.items()})
    assert profiling.counters() == c


# -- on the card: replays against the eager plan --------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    gn._reset_graphs()
    yield torch.device("cuda", 0)
    gn._reset_graphs()
    torch.cuda.empty_cache()


_CELLS = {}


def _cell_problem(b, dev, call=0):
    """(spec, robot, params, th0, sdf) of one call of ``b`` problems of the
    benchmark cell ``point2d.b10240`` (its forest pool and planner, from a
    fixed seed), float32 on the card."""
    from portbench import spec as bench_spec
    from portbench.systems.point2d import Driver

    if b not in _CELLS:
        cell = bench_spec.cell("point2d.b10240")
        traffic = dict(cell.traffic, batch=b,
                       worlds=min(int(cell.traffic["worlds"]), b))
        _CELLS[b] = Driver(dataclasses.replace(cell, traffic=traffic),
                           2718281828, dev)
    d = _CELLS[b]
    idx = torch.from_numpy(d.pool.draw(call)).to(dev)
    x = d.pool.inputs(idx, d.horizon, d.steps)
    pl = d.planner
    return (pl.spec, pl.robot, pl.make_params(x["start"], x["goal"]),
            x["th0"], x["sdf"]), pl.cfg


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["standard", "stream"])
@pytest.mark.parametrize("track_best", [False, True])
@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
@pytest.mark.parametrize("b", [1024, 10240])
def test_replay_is_bit_equal_to_eager_on_the_card(dev, b, method, track_best,
                                                  engine):
    problem, cfg = _cell_problem(b, dev)
    cfg = dataclasses.replace(cfg, method=method, engine=engine)
    with torch.no_grad():
        ref = gn._eager_plan(*problem, cfg, track_best=track_best)
        outs = [gn.plan(*problem, cfg, track_best=track_best)
                for _ in range(3)]
    assert gn.graph_counts == {"eager": 2, "captures": 1,
                                        "replays": 1, "evictions": 0}
    for o in outs:
        assert _same(o, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
def test_df32_replay_is_bit_equal_to_eager_on_the_card(dev, method):
    problem, cfg = _cell_problem(1024, dev)
    cfg = dataclasses.replace(cfg, method=method, engine="df32")
    with torch.no_grad():
        ref = gn._eager_plan(*problem, cfg, track_best=True)
        outs = [gn.plan(*problem, cfg, track_best=True) for _ in range(3)]
    assert all(_same(o, ref) for o in outs)


@pytest.mark.cuda
def test_new_inputs_replay_to_their_eager_answers_and_old_ones_survive(dev):
    """Another draw (SDF, start, goal, seed) between replays gives the eager
    answers of that draw; call k's outputs survive call k + 1."""
    cfg = None
    held, refs = [], []
    with torch.no_grad():
        for call in range(4):
            problem, cfg = _cell_problem(1024, dev, call)
            refs.append(gn._eager_plan(*problem, cfg))
            held.append(gn.plan(*problem, cfg))
    counts = gn.graph_counts
    assert (counts["captures"], counts["replays"]) == (1, 2)
    for o, r in zip(held, refs):
        assert _same(o, r)
    assert not torch.equal(held[2].th, held[3].th)


@pytest.mark.cuda
def test_requires_grad_under_grad_stays_eager_on_the_card(dev):
    problem, cfg = _cell_problem(1024, dev)
    spec, robot, params, th0, sdf = problem
    cfg = dataclasses.replace(cfg, max_iters=5)
    grads = []
    for run in (gn.plan, gn.plan, gn._eager_plan):
        q = params.obs_inv.detach().clone().requires_grad_(True)
        out = run(spec, robot, dataclasses.replace(params, obs_inv=q), th0,
                  sdf, cfg)
        out.err_ext_per_iter.sum().backward()
        grads.append(q.grad)
    assert gn.graph_counts == {"eager": 3, "captures": 0,
                                        "replays": 0, "evictions": 0}
    assert torch.equal(grads[0], grads[2]) and torch.equal(grads[1], grads[2])


@pytest.mark.cuda
def test_launch_counters_after_n_replays_on_the_card(dev):
    problem, cfg = _cell_problem(1024, dev)
    with torch.no_grad():
        before = profiling.counters()
        gn._eager_plan(*problem, cfg)
        torch.cuda.synchronize()
        mid = profiling.counters()
        one = {k: mid[k] - before[k] for k in mid}
        n = 5
        for _ in range(n):
            gn.plan(*problem, cfg)
        torch.cuda.synchronize()
    after = profiling.counters()
    assert one["btd_solve"] == cfg.max_iters
    # The wrappers count the first plan, eager; the graph's n - 1 replays
    # ran the eager plan's kernels each.
    assert {k: after[k] - mid[k] for k in after} == one
    assert dict(gn.graph_launches) == {k: (n - 1) * v
                                       for k, v in one.items() if v}


@pytest.mark.cuda
def test_a_replay_opens_only_the_plan_span_and_its_kernels_are_traced(dev):
    """Under the profiler a replay opens ``dgpmp2.plan`` alone, and the
    profiler sees the graph's kernels: K-BTD once an iteration."""
    problem, cfg = _cell_problem(1024, dev)
    with torch.no_grad():
        for _ in range(2):
            gn.plan(*problem, cfg)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            gn.plan(*problem, cfg)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("dgpmp2.plan") == 1
    assert not [n for n in names if n.startswith("dgpmp2.")
                and n != "dgpmp2.plan"]
    plan = next(e for e in prof.events() if e.name == "dgpmp2.plan")
    assert plan.kwinputs["graph"] == "replay"
    kbtd = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "btd_solve_kernel" in e.name]
    assert len(kbtd) == cfg.max_iters


@pytest.mark.cuda
def test_the_cache_stays_bounded_on_the_card(dev):
    cfg = _cfg(max_iters=2)
    with torch.no_grad():
        for b in range(1, gn.GRAPH_CACHE + 3):
            problem = _problem(b, dev=dev, dtype=torch.float32)
            ref = gn._eager_plan(*problem, cfg)
            for _ in range(3):
                assert _same(gn.plan(*problem, cfg), ref)
    assert len(gn._graphs) == gn.GRAPH_CACHE
    counts = gn.graph_counts
    assert counts["captures"] == gn.GRAPH_CACHE + 2
    assert counts["evictions"] == 2


_PATHS = {}
# chip_smoke.constrained_problems's paths, the 3-D bench and the 2-D bench
# under the one-limb lookup engine.
PATHS = ("2-link arm", "heading robot", "task-space 3-link arm",
         "GP interpolation + velocity limits", "4-link arm", "5-link arm",
         "9-link arm", "17-link arm", "3-D", "2-D limbs")


def _path(name, dev):
    """(problem, cfg) of one of :data:`PATHS` at chip_smoke's B=1024,
    float32, 8 iterations."""
    import chip_smoke as cs

    if not _PATHS:
        for n, (pl, *inputs) in cs.constrained_problems(
                dev, cs.bench_inputs(cs.B)).items():
            _PATHS[n] = (cs.problem_of(pl, *inputs), pl.cfg)
        base = gn.OptimConfig(reg=0.1, max_iters=8, tol_delta=0.0)
        _PATHS["3-D"] = (cs.port_problem(*cs.bench3d_inputs(cs.B, dev), dev,
                                         torch.float32), base)
        _PATHS["2-D limbs"] = (cs.port_problem(*cs.bench_inputs(cs.B), dev,
                                               torch.float32), base)
    problem, cfg = _PATHS[name]
    return problem, dataclasses.replace(cfg, max_iters=8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PATHS)
def test_every_robot_and_lookup_engine_replays_bit_equal_on_the_card(
        dev, name):
    """The constrained robots (self-collision, joint limits, the heading
    robot, the workspace goal under LM, GP interpolation and velocity
    limits, arms to D = 34), the 3-D lookup and the limb lookup capture, and
    replay to the eager loop's bits; under the limb engine each replay
    splits the SDF once, as an eager plan of a new SDF does."""
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs

    problem, cfg = _path(name, dev)
    with (_lookup_method("pallas_v3_1") if name == "2-D limbs"
          else contextlib.nullcontext()), torch.no_grad():
        ref = gn._eager_plan(*problem, cfg)
        outs = [gn.plan(*problem, cfg) for _ in range(2)]
        splits = sdf_lookup_limbs.splits
        graph_splits = gn.graph_launches["sdf_lookup_limbs.splits"]
        outs.append(gn.plan(*problem, cfg))
    assert sdf_lookup_limbs.splits == splits
    assert (gn.graph_launches["sdf_lookup_limbs.splits"] - graph_splits
            == (name == "2-D limbs"))
    assert gn.graph_counts["captures"] == 1
    assert all(_same(o, ref) for o in outs)


@pytest.mark.cuda
def test_callers_on_two_streams_each_get_their_own_answers(dev):
    """Calls of one key alternate between two streams with other inputs and
    no synchronisation between them: each answers its own inputs' eager
    plan (a call waits for the last call's clones before it copies its
    inputs over the static buffers)."""
    problems = [_cell_problem(1024, dev, call) for call in (0, 1)]
    cfg = problems[0][1]
    with torch.no_grad():
        refs = [gn._eager_plan(*p, cfg) for p, _ in problems]
        for _ in range(2):
            gn.plan(*problems[0][0], cfg)  # eager, then the capture
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        outs = []
        for k in range(6):
            with torch.cuda.stream(streams[k % 2]):
                outs.append(gn.plan(*problems[k % 2][0], cfg))
        torch.cuda.synchronize()
    assert gn.graph_counts["replays"] == 6
    for k, o in enumerate(outs):
        assert _same(o, refs[k % 2])


@pytest.mark.cuda
def test_keys_replayed_in_another_order_than_captured_answer_bit_equal(dev):
    """The graphs of one device share its memory pool: three keys (B = 256,
    512, 1024) captured in one order and replayed in others answer
    bit-equal to their eager plans."""
    problems = {b: _cell_problem(b, dev)[0] for b in (256, 512, 1024)}
    cfg = _cell_problem(256, dev)[1]
    with torch.no_grad():
        refs = {b: gn._eager_plan(*p, cfg) for b, p in problems.items()}
        for b in (256, 512, 1024):
            for _ in range(2):
                gn.plan(*problems[b], cfg)  # eager, then the capture
        outs = [(b, gn.plan(*problems[b], cfg))
                for b in (1024, 256, 512, 512, 1024, 256)]
    assert len(gn._pools) == 1
    assert gn.graph_counts == {"eager": 6, "captures": 3, "replays": 6,
                               "evictions": 0}
    for b, o in outs:
        assert _same(o, refs[b])


@pytest.mark.cuda
def test_the_service_captures_in_its_warmup_and_replays_a_dispatch(dev):
    """``PlanningService.warmup`` plans twice on the card, so its key's
    graph is captured there, and a dispatch of the same shapes replays it,
    answering what the eager loop answers."""
    import chip_smoke as cs
    from dgpmp2_tpu_torch import serve

    imgs, start, goal = cs.bench_inputs(8)
    svc = serve.PlanningService(cs.planner_from_yaml("2d", dev),
                                batch_size=8)
    svc.register_world("w", cs.occupancy_sdf(imgs[:1], dev)[0].cpu().numpy())
    reqs = [serve.PlanRequest(start=start[i], goal=goal[i], world="w")
            for i in range(8)]
    svc.warmup()
    assert gn.graph_counts == {"eager": 1, "captures": 1, "replays": 0,
                               "evictions": 0}
    with cs.eager_plans():
        want = svc.plan_batch_sync(reqs)
    got = svc.plan_batch_sync(reqs)
    assert gn.graph_counts == {"eager": 2, "captures": 1, "replays": 1,
                               "evictions": 0}
    for g, w in zip(got, want):
        assert np.array_equal(g.th, w.th) and g.iters == w.iters
        assert g.err_final == w.err_final
