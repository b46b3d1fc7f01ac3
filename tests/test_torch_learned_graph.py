"""``LearnedDiffGPMP2Planner.plan``'s captured loop: when it engages, what
its key tells apart, that a replay answers as the eager loop does, and that
the plan follows the benchmark's plain float64 reference.

On the CPU (Tier-1): the decision, the key, the counters, the spans and the
encoder's hooks, with the plan's device type set to the CPU and the CUDA
graph replaced by a fake that runs the captured call again on the static
buffers (``_torch_graph``); and the plan, eager and through the fake graph,
against ``portbench.reference.learned`` in float64.  Marked ``cuda`` (they
skip without a card): replays bit-equal to the eager loop at the benchmark
cell ``learned2d.b1024``'s problem, and the learned service.  On the card,
with no JAX there:

    python -m pytest tests/test_torch_learned_graph.py --noconftest -m cuda
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.parallel import sharding
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.utils import profiling
from dgpmp2_tpu_torch.utils.tree import leaves
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

from _torch_graph import fake_card  # noqa: F401 - a fixture

F64 = torch.float64
# The campaign's eps_bounded planner at a cost_sigma of 0.05, and its heads.
LKW = dict(dynamics_mode="diag_identity", learn_eps=True, eps_max=0.8,
           static_init=(1.0, 0.05, 0.4), dropout_prob=0.1)
HEADS = {"feed_forward": {},
         "rnn_gru": dict(model_type="rnn_gru", hidden_dim=16),
         "rnn_lstm": dict(model_type="rnn_lstm", hidden_dim=16)}


def _problem(b=3, t=8, n=32, seed=0, dev="cpu", dtype=F64):
    """(spec, robot, params, th0, sdf, im) of ``b`` 2-D problems: one box
    in each n x n world, start and goal on either side."""
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
    im = torch.tensor(occ, dtype=dtype, device=dev)
    return spec, robot, params, th0, sdf, im


def _planner(problem, head="feed_forward", method="gauss_newton", iters=3,
             seed=0, dev="cpu", dtype=F64):
    """(planner, variables): the planner's own init from a seeded
    generator, every weight then moved by seeded noise off the static
    initialisation."""
    spec, robot, _, th0, sdf, im = problem
    planner = LearnedDiffGPMP2Planner(
        spec, robot, gn.OptimConfig(reg=0.1, max_iters=iters, method=method,
                                    tol_delta=0.0),
        LearnedPlannerConfig(**LKW, **HEADS[head], dtype=dtype), device=dev)
    variables = planner.init_variables(torch.Generator().manual_seed(seed),
                                       planner.stack_inputs(im, sdf), th0)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for w in variables.parameters():
            w.add_(0.01 * torch.randn(w.shape, generator=gen,
                                      dtype=w.dtype).to(w.device))
    return planner, variables


def _plan(planner, variables, problem, **kw):
    _, _, params, th0, sdf, im = problem
    with torch.no_grad():
        return planner.plan(variables, params, th0, sdf, im, **kw)


@contextlib.contextmanager
def _eager():
    """Every plan inside the block runs the eager loop."""
    device, gn._GRAPH_DEVICE = gn._GRAPH_DEVICE, None
    try:
        yield
    finally:
        gn._GRAPH_DEVICE = device


def _same(a: tuple, b: tuple) -> bool:
    """Every output of two learned plans bit for bit (``None`` where the
    other's is)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        xs, ys = leaves(x), leaves(y)
        if len(xs) != len(ys) or not all(
                u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v)
                for u, v in zip(xs, ys)):
            return False
    return True


def _key(planner, variables, problem, iters=None, hidden=None,
         track_best=False, return_final=False):
    _, _, params, th0, sdf, im = problem
    return planner._graph_key(variables, params, th0, sdf, im,
                              iters or planner.cfg.max_iters, hidden,
                              track_best, return_final)


# -- on the CPU: the decision, the key, the counters ---------------------------

# Each head and path the loop has: the feed-forward and GRU heads with and
# without track_best and the final iterate, LM with either head, and the
# LSTM head, whose zero carry is one tensor twice.
CASES = ([(h, "gauss_newton", tb, rf) for h in ("feed_forward", "rnn_gru")
          for tb in (False, True) for rf in (False, True)]
         + [("feed_forward", "lm", True, True), ("rnn_gru", "lm", True, False),
            ("rnn_lstm", "gauss_newton", True, True)])


@pytest.mark.parametrize("head,method,track_best,return_final", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_replays_answer_as_the_eager_loop(fake_card, head, method,
                                          track_best, return_final):
    """Eager, capture, replay: every output bit-equal to the eager loop's,
    the counters read what happened, new inputs replay to their own eager
    answers, and a replay's outputs survive the next one."""
    problem = _problem()
    planner, variables = _planner(problem, head, method)
    kw = dict(track_best=track_best, return_final=return_final)
    with _eager():
        ref = _plan(planner, variables, problem, **kw)
    gn._reset_graphs()
    outs = [_plan(planner, variables, problem, **kw) for _ in range(4)]
    assert all(_same(o, ref) for o in outs)
    assert gn.graph_counts == {"eager": 1, "captures": 1, "replays": 2,
                               "evictions": 0}
    problem2 = _problem(seed=5)
    with _eager():
        ref2 = _plan(planner, variables, problem2, **kw)
    new = _plan(planner, variables, problem2, **kw)
    assert gn.graph_counts["replays"] == 3
    assert _same(new, ref2) and not torch.equal(new[0], ref[0])
    assert all(_same(o, ref) for o in outs)


def test_the_decision_declines_every_learned_plan_on_the_cpu():
    problem = _problem(2)
    planner, variables = _planner(problem)
    with torch.no_grad():
        assert _key(planner, variables, problem) is None
    gn._reset_graphs()
    for _ in range(2):
        _plan(planner, variables, problem)
    assert gn.graph_counts == {"eager": 2, "captures": 0, "replays": 0,
                               "evictions": 0}
    gn._reset_graphs()


def test_the_decision_declines_weights_that_require_grad_under_grad(
        fake_card):
    """The weights are parameters that require grad: under grad mode the
    plan runs eagerly (autograd records it), under ``no_grad`` it may
    capture; a seed that requires grad declines too.  Gradients through
    the plan are the eager loop's."""
    problem = _problem(2)
    planner, variables = _planner(problem)
    assert _key(planner, variables, problem) is None
    with torch.no_grad():
        assert _key(planner, variables, problem) is not None
    spec, robot, params, th0, sdf, im = problem
    seed = th0.clone().requires_grad_(True)
    with torch.no_grad():
        assert _key(planner, variables, problem) is not None
    assert _key(planner, variables,
                (spec, robot, params, seed, sdf, im)) is None
    head = variables["head"].out.weight
    grads = []
    for _ in range(3):
        head.grad = None
        _, _, errs_ext, _ = planner.plan(variables, params, th0, sdf, im)
        errs_ext.sum().backward()
        grads.append(head.grad.clone())
    assert all(torch.equal(g, grads[0]) for g in grads)
    assert gn.graph_counts == {"eager": 3, "captures": 0, "replays": 0,
                               "evictions": 0}


def test_sharded_weights_plan_each_shard_and_each_replica_may_capture(
        fake_card):
    """``ShardedParams`` are not a key: each data shard's replica plans its
    rows, and each replica's loop takes the captured path (its own copy of
    the weights, so its own key), answering as the eager sharded plan."""
    problem = _problem(4)
    planner, variables = _planner(problem)
    _, _, params, th0, sdf, im = problem
    mesh = sharding.make_mesh([torch.device("cpu")] * 2)
    sharded = sharding.shard_params(variables, mesh)
    with _eager(), torch.no_grad():
        ref = planner.plan(sharded, params, th0, sdf, im, track_best=True)
    gn._reset_graphs()
    with torch.no_grad():
        outs = [planner.plan(sharded, params, th0, sdf, im, track_best=True)
                for _ in range(3)]
    assert gn.graph_counts == {"eager": 2, "captures": 2, "replays": 2,
                               "evictions": 0}
    assert all(_same(o, ref) for o in outs)


@pytest.mark.parametrize("change", [
    "replaced_weight", "iters", "carry", "tf32", "track_best",
    "return_final", "method", "head", "planner"])
def test_the_key_separates(fake_card, change):
    """Each of these gives another key than the base plan's (a GRU head, so
    that a carry can be given); a weight updated in place keeps the key, as
    the graph reads the weights where they are."""
    problem = _problem(3)
    planner, variables = _planner(problem, "rnn_gru")
    with torch.no_grad():
        base = _key(planner, variables, problem)
        assert base is not None
        variables["head"].out.bias.add_(1.0)
        assert _key(planner, variables, problem) == base
        kw = {}
        settings = contextlib.nullcontext()
        if change == "replaced_weight":
            out = variables["head"].out
            out.bias = torch.nn.Parameter(out.bias.detach().clone())
        elif change == "iters":
            kw["iters"] = planner.cfg.max_iters + 1
        elif change == "carry":
            kw["hidden"] = planner.init_hidden(variables, 3)
        elif change == "tf32":
            old = torch.backends.cuda.matmul.allow_tf32

            @contextlib.contextmanager
            def settings():
                torch.backends.cuda.matmul.allow_tf32 = not old
                try:
                    yield
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = old
            settings = settings()
        elif change in ("track_best", "return_final"):
            kw[change] = True
        elif change == "method":
            planner = _planner(problem, "rnn_gru", method="lm")[0]
        elif change == "head":
            planner, variables = _planner(problem, "feed_forward")
        elif change == "planner":
            planner = planner.replica(planner.device)
            planner.learn_cfg = dataclasses.replace(planner.learn_cfg,
                                                    eps_max=0.9)
        with settings:
            key = _key(planner, variables, problem, **kw)
    assert key is not None and key != base


def test_an_update_in_place_between_replays_answers_with_the_new_weights(
        fake_card):
    """An optimizer's step updates the weights in place: the next replay
    answers the eager plan of the new weights, with no new capture; a
    weight replaced by a new tensor makes a new key, planned eagerly."""
    problem = _problem(2)
    planner, variables = _planner(problem)
    for _ in range(2):
        _plan(planner, variables, problem)
    with torch.no_grad():
        for w in variables.parameters():
            w.mul_(1.05)
    with _eager():
        ref = _plan(planner, variables, problem)
    got = _plan(planner, variables, problem)
    assert _same(got, ref)
    assert gn.graph_counts == {"eager": 2, "captures": 1, "replays": 1,
                               "evictions": 0}
    out = variables["head"].out
    out.weight = torch.nn.Parameter(out.weight.detach() * 1.05)
    with _eager():
        ref = _plan(planner, variables, problem)
    assert _same(_plan(planner, variables, problem), ref)
    assert gn.graph_counts["eager"] == 4


def test_one_replay_is_counted_a_call_and_the_capture_not(fake_card,
                                                           monkeypatch):
    """Kernel wrappers counting on the CPU: of n learned plans of one key
    the wrappers count the eager one's launches; the n − 1 replays (the
    capture's first included) add its launches to ``gn.graph_launches``
    each, and the capture adds nothing."""
    from _torch_examples import count_plain_launches

    count_plain_launches(monkeypatch)
    problem = _problem(2)
    planner, variables = _planner(problem)
    before = profiling.counters()
    with _eager():
        _plan(planner, variables, problem, track_best=True)
    mid = profiling.counters()
    one = {k: mid[k] - before[k] for k in mid}
    iters = planner.cfg.max_iters
    assert one["btd_solve"] == iters
    assert one["sdf_lookup"] == iters + 1
    gn._reset_graphs()
    n = 4
    for _ in range(n):
        _plan(planner, variables, problem, track_best=True)
    after = profiling.counters()
    assert {k: after[k] - mid[k] for k in after} == one
    assert dict(gn.graph_launches) == {k: (n - 1) * v
                                       for k, v in one.items() if v}
    assert gn.graph_counts["replays"] == n - 2


def test_the_encoder_runs_on_every_call_inside_the_plan_span(fake_card):
    """The encoder's forward hooks and its span ``dgpmp2.encoder`` (under
    ``dgpmp2.plan``) open on every call, replays included, and the plan
    span names the path."""
    problem = _problem(2)
    planner, variables = _planner(problem)
    calls = []
    hook = variables["conv"].register_forward_pre_hook(
        lambda *_: calls.append(1))
    paths = []
    try:
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU],
                    record_shapes=True) as prof:
                _plan(planner, variables, problem)
            plan = [e for e in prof.events() if e.name == "dgpmp2.plan"]
            enc = [e for e in prof.events() if e.name == "dgpmp2.encoder"]
            assert len(plan) == 1 and len(enc) == 1
            assert enc[0].cpu_parent.name == "dgpmp2.plan"
            paths.append(plan[0].kwinputs["graph"])
    finally:
        hook.remove()
    assert paths == ["eager", "capture", "replay"]
    assert len(calls) == 3


# -- on the CPU: the plan against the benchmark's plain reference --------------

# The port's float64 plan against the plain float64 reference
# (portbench/reference/learned.py), two iterations on the benchmark's
# weights, and why each tolerance holds it (seen over eight seeds of this
# size, and what a float32 plan gives):
# - "ext0", errs_ext[0]: the seed's error under the fixed covariances,
#   which no float32 number reaches in a float64 plan: float64 rounding of
#   a sum over the factors (seen ≤ 2.1e-16; float32 ≥ 1.4e-7).
# - "err0", errs[0]: the seed's error under the first predicted
#   covariances; the port casts the head's output to float32 before the
#   decode, as the JAX package does, so each weight is the square of a
#   float32 number: two roundings of 2^-24 (seen ≤ 6.8e-8).
# - "step1", errs[1] and errs_ext[1]: after one step on those covariances,
#   whose float32 rounding the step's conditioning (obstacle weights of
#   1/0.01²) amplifies (seen ≤ 6.0e-7; float32 ≥ 8.0e-6).
# - "th", th and th_final after two steps, metres (seen ≤ 1.8e-6; float32
#   ≥ 1.6e-4).
REF_TOL = {"ext0": 1e-12, "err0": 2.4e-7, "step1": 3e-6, "th": 2e-5}
REF_T, REF_SIZE, REF_B, REF_ITERS = 20, 64, 4, 2


def _reference_gaps(dtype, captured):
    """The widest gaps of the port's plan in ``dtype`` (eager, or the
    third plan of its key: a replay) against the reference, by tolerance."""
    from portbench import worlds
    from portbench.reference import learned
    from portbench.systems import learned2d, point2d
    from portbench import spec as bench_spec

    cfg = bench_spec.load_json(bench_spec.HERE / "configs" / "learned2d.json")
    cfg["planner_params"]["total_time_step"] = REF_T
    cfg["env"]["im_size"] = REF_SIZE
    gen = torch.Generator().manual_seed(2)
    maps, starts, goals = worlds.forest_bank(gen, REF_B, 1, REF_SIZE,
                                             (-5.0, 5.0), (-5.0, 5.0), 0.4,
                                             "cpu")
    sdf64 = worlds.sdf_from_map(maps, 10.0 / REF_SIZE).double()
    start = torch.zeros(REF_B, 4, dtype=F64)
    goal = torch.zeros(REF_B, 4, dtype=F64)
    start[:, :2] = starts[:, 0]
    goal[:, :2] = goals[:, 0]
    th0 = worlds.straight_line(start[:, :2], goal[:, :2], 10.0, REF_T)
    w64 = learned2d.make_weights(cfg, 1002, "cpu", F64)
    lc, cov, gp = cfg["learned"], cfg["obs_params"], cfg["gp_params"]
    spec = graph.GraphSpec(total_time_step=REF_T)
    robot = PointRobot2D()
    planner = LearnedDiffGPMP2Planner(
        spec, robot, gn.OptimConfig(reg=0.1, max_iters=REF_ITERS),
        LearnedPlannerConfig(dynamics_mode=lc["dynamics_mode"],
                             learn_eps=lc["learn_eps"], eps_max=lc["eps_max"],
                             static_init=tuple(lc["static_init"]),
                             dropout_prob=lc["dropout_prob"], dtype=dtype),
        device="cpu")
    im, sdf = maps.to(dtype), sdf64.to(dtype)
    variables = planner.load_variables(
        {k: v.to(dtype) for k, v in w64.items()},
        planner.stack_inputs(im, sdf), th0.to(dtype))
    params = graph.default_params(
        spec, robot, start.to(dtype), goal.to(dtype),
        qc_inv=np.asarray(gp["Q_c_inv"]), cost_sigma=cov["cost_sigma"],
        epsilon_dist=cov["epsilon_dist"], k_s=gp["K_s"], k_g=gp["K_g"],
        dtype=dtype)
    problem = (spec, robot, params, th0.to(dtype), sdf, im)
    kw = dict(track_best=True, return_final=True)
    if captured:
        outs = [_plan(planner, variables, problem, **kw) for _ in range(3)]
        assert gn.graph_counts["replays"] == 1
        th, errs, ext, _, th_final = outs[-1]
    else:
        with _eager():
            th, errs, ext, _, th_final = _plan(planner, variables, problem,
                                               **kw)
    fixed = point2d.problem(cfg, sdf64, start, goal, F64)
    r_th, r_errs, r_ext, r_final = learned.plan(
        w64, fixed, maps.double(), th0, 0.1, REF_ITERS, lc["eps_max"])

    def rel(a, b):
        return float(((a.double() - b) / b.abs()).abs().max())

    return {"ext0": rel(ext[0], r_ext[0]), "err0": rel(errs[0], r_errs[0]),
            "step1": max(rel(errs[1], r_errs[1]), rel(ext[1], r_ext[1])),
            "th": max(float((th.double() - r_th).abs().max()),
                      float((th_final.double() - r_final).abs().max()))}


@pytest.mark.parametrize("path", ["eager", "captured"])
def test_the_plan_follows_the_plain_reference(fake_card, path):
    gaps = _reference_gaps(F64, path == "captured")
    assert all(gaps[k] <= REF_TOL[k] for k in REF_TOL), gaps


def test_a_float32_plan_fails_the_reference_tolerances(fake_card):
    """The tolerances tell the float64 plan from one a precision below."""
    gaps = _reference_gaps(torch.float32, False)
    assert all(gaps[k] > REF_TOL[k] for k in ("ext0", "step1", "th")), gaps


# -- on the card: replays against the eager loop -------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    gn._reset_graphs()
    yield torch.device("cuda", 0)
    gn._reset_graphs()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    torch.cuda.empty_cache()


def _cell(dev):
    """The ``Driver`` of the benchmark cell ``learned2d.b1024`` (its forest
    pool, its planner and weights, from a fixed seed) on the card, with the
    cell's TF32 setting, and a function of a call's inputs."""
    from portbench import spec as bench_spec
    from portbench.systems.learned2d import Driver

    cell = bench_spec.cell("learned2d.b1024")
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    d = Driver(cell, 2718281828, dev)

    def problem(call=0, b=None):
        idx = torch.from_numpy(d.pool.draw(call)).to(dev)[:b]
        x = d.pool.inputs(idx, d.horizon, d.steps)
        im = d.pool.maps.index_select(0, x["world"])
        return (d.planner.spec, d.planner.robot,
                d._params(x["start"], x["goal"]), x["th0"], x["sdf"], im)

    return d, problem


@pytest.mark.cuda
def test_replay_is_bit_equal_to_eager_at_the_cell_on_the_card(dev):
    """B=1024, T=100, 50 iterations, the feed-forward head, track_best and
    the final iterate, as the cell plans: each replay bit-equal to the
    eager loop, and another call's inputs replay to their own eager
    answers."""
    d, problem = _cell(dev)
    kw = dict(max_iters=d.iters, track_best=True, return_final=True)
    p0, p1 = problem(0), problem(1)
    with _eager():
        refs = [_plan(d.planner, d.variables, p, **kw) for p in (p0, p1)]
    outs = [_plan(d.planner, d.variables, p0, **kw) for _ in range(3)]
    outs.append(_plan(d.planner, d.variables, p1, **kw))
    assert gn.graph_counts == {"eager": 3, "captures": 1, "replays": 2,
                               "evictions": 0}
    assert all(_same(o, refs[0]) for o in outs[:3])
    assert _same(outs[3], refs[1])


@pytest.mark.cuda
def test_gru_replay_is_bit_equal_to_eager_on_the_card(dev):
    """The GRU head at B=256 of the cell's problems, 50 iterations."""
    d, problem = _cell(dev)
    p = problem(0, 256)
    planner, variables = _planner(p, "rnn_gru", iters=d.iters, dev=dev,
                                  dtype=torch.float32)
    kw = dict(track_best=True, return_final=True)
    with _eager():
        ref = _plan(planner, variables, p, **kw)
    outs = [_plan(planner, variables, p, **kw) for _ in range(3)]
    assert gn.graph_counts == {"eager": 2, "captures": 1, "replays": 1,
                               "evictions": 0}
    assert all(_same(o, ref) for o in outs)


@pytest.mark.cuda
def test_the_learned_service_captures_in_its_warmup_and_replays(dev):
    """``LearnedPlanningAdapter`` under ``PlanningService``: the warm-up
    plans twice, so the learned loop's graph is captured there, and a
    dispatch of the same shapes replays it, answering as the eager loop."""
    import chip_smoke as cs
    from dgpmp2_tpu_torch import serve

    imgs, start, goal = cs.bench_inputs(8)
    lplanner, variables = cs.learned_setup(dev, imgs, start, goal, iters=20,
                                           weights_seed=5)[:2]
    cov = dict(qc_inv=np.eye(2), cost_sigma=0.01, epsilon_dist=0.4,
               k_s=0.01, k_g=0.01)
    svc = serve.PlanningService(
        serve.LearnedPlanningAdapter(lplanner, variables, cov), batch_size=8)
    svc.register_world("w", cs.occupancy_sdf(imgs[:1], dev)[0].cpu().numpy())
    reqs = [serve.PlanRequest(start=start[i], goal=goal[i], world="w")
            for i in range(8)]
    gn._reset_graphs()
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
