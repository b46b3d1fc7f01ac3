"""dgpmp2_tpu_torch.utils.profiling on the CPU: ``time_compiled`` returns a
positive time per iteration and runs the plain loop (its carry equals the
loop's, as ``tests/test_aux.py:133`` times JAX's), ``trace`` writes a
Chrome trace and ``annotate`` nests.  The CUDA-graph capture runs only on
the card (``tests/test_torch_cuda.py``).

The GN loops' spans: with no profiler running a plan enters no profiler
range (every engine, LM, the learned plan); under the profiler each stage
span sits under ``dgpmp2.plan`` as often as the loop runs it, and the plan's
outputs are the same bits with and without the profiler."""
import collections
import json

import jax.numpy as jnp
import pytest
import torch

from dgpmp2_tpu.utils.profiling import time_compiled as j_time_compiled
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.utils import profiling
from dgpmp2_tpu_torch.utils.tree import leaves, tree_map

from _torch_parity import both_problems, learned_pair

torch.set_num_threads(1)


def test_time_compiled_harness_matches_jax_usage():
    """tests/test_aux.py:133's step in both packages."""
    def step(c, a):
        return c * 0.999 + a

    ms = profiling.time_compiled(step, torch.ones(64), torch.ones(64) * 1e-3,
                                 iters=10, repeats=1)
    assert ms > 0.0
    assert j_time_compiled(step, jnp.ones((64,)), jnp.ones((64,)) * 1e-3,
                           iters=10, repeats=1) > 0.0


def test_time_compiled_runs_the_plain_loop_on_the_cpu():
    """The steps it times are the plain loop's: a recording step sees the
    untimed run and every repeat continue one carry, a GN plan's steps
    included (tuple carries too)."""
    seen = []

    def step(carry, a):
        x, n = carry
        seen.append(float(n))
        return x * 0.5 + a, n + 1

    ms = profiling.time_compiled(step, (torch.ones(3), torch.zeros(())),
                                 torch.ones(3), iters=4, repeats=2)
    assert ms > 0.0 and seen == list(range(12))

    (_, pt) = both_problems(seed=1, b=2, t=10)
    spec, robot, params, th0, sdf = pt
    delta = torch.tensor(0.1, dtype=th0.dtype)

    def gn_step(th, p, s):
        return th + tgn.gn_step(spec, robot, p, th, s, delta)

    loop = th0
    for _ in range(3):
        loop = gn_step(loop, params, sdf)
    out = {}

    def recording(th, p, s):
        out["th"] = gn_step(th, p, s)
        return out["th"]

    profiling.time_compiled(recording, th0, params, sdf, iters=3, repeats=0)
    assert torch.equal(out["th"], loop)


def test_trace_writes_a_chrome_trace_and_annotate_nests(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    spans = {e["name"]: e for e in events["traceEvents"]
             if e.get("name") in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_launch_counts_name_every_kernel_and_capture_needs_the_card():
    assert set(profiling.launch_counts()) == {
        "btd_solve", "btd_stream", "sdf_lookup", "sdf_lookup3d",
        "sdf_lookup_limbs", "sdf_lookup_bwd", "encoder_norm"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            profiling.CapturedSteps(lambda c: c, torch.ones(2), iters=1)


STAGES = ("dgpmp2.residuals", "dgpmp2.assemble", "dgpmp2.solve",
          "dgpmp2.errors", "dgpmp2.update")
ITERS = 3


def _gn_case(engine, method, track_best):
    """A small 2-D plan of ``ITERS`` iterations under ``engine`` and
    ``method``: a function of no arguments returning its outputs as a
    tuple of tensors (df32 plans in float32, the rest in float64)."""
    _, pt = both_problems(seed=2, b=3, t=8)
    if engine == "df32":
        pt = tree_map(lambda x: x.float() if x.is_floating_point() else x, pt)
    spec, robot, params, th0, sdf = pt
    cfg = tgn.OptimConfig(method=method, engine=engine, max_iters=ITERS,
                          tol_delta=0.0)
    return lambda: tuple(leaves(tuple(tgn.plan(
        spec, robot, params, th0, sdf, cfg, track_best=track_best))))


def _learned_case(method):
    _, tp, _ = learned_pair({}, method=method, max_iters=ITERS)
    planner, variables, params, th0, sdf, im = tp

    def run():
        with torch.no_grad():
            return tuple(leaves(planner.plan(variables, params, th0, sdf, im,
                                             track_best=True,
                                             return_final=True)))
    return run


PLANS = {"standard": lambda: _gn_case("standard", "gauss_newton", False),
         "stream": lambda: _gn_case("stream", "gauss_newton", True),
         "df32": lambda: _gn_case("df32", "gauss_newton", True),
         "lm": lambda: _gn_case("standard", "lm", True),
         "learned": lambda: _learned_case("gauss_newton"),
         "learned_lm": lambda: _learned_case("lm")}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_a_plan_enters_no_profiler_range_without_a_profiler(case,
                                                            monkeypatch):
    """The spans cost one flag check: with no profiler running, no
    ``RecordFunction`` of either kind is made, and ``annotate`` hands back
    one shared no-op context."""
    run = PLANS[case]()

    def refuse(*a, **k):
        raise AssertionError("a profiler range made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out = run()
    assert all(torch.isfinite(x).all() for x in out if x.is_floating_point())
    assert profiling.annotate("dgpmp2.plan", {"B": 1}) is \
        profiling.annotate("dgpmp2.errors")


# Span instances of an ITERS-iteration plan (n = ITERS): the standard
# engine's plan without track_best; the others with it, which opens a
# second update an iteration (the best iterate kept).
N = ITERS
COUNTS = {
    "standard": {"dgpmp2.plan": 1, "dgpmp2.residuals": N + 1,
                 "dgpmp2.assemble": N, "dgpmp2.solve": N,
                 "dgpmp2.errors": 2 * N + 1, "dgpmp2.update": N},
    "lm": {"dgpmp2.plan": 1, "dgpmp2.residuals": N + 1,
           "dgpmp2.assemble": N, "dgpmp2.solve": N,
           "dgpmp2.errors": 2 * N + 1, "dgpmp2.update": 2 * N},
    "stream": {"dgpmp2.plan": 1, "dgpmp2.residuals": N + 1,
               "dgpmp2.solve": N, "dgpmp2.errors": 2 * N + 1,
               "dgpmp2.update": 2 * N},
    # The learned plan scores and keeps the best iterate under the fixed
    # params (residuals and errors each time), and its GN step has no
    # accept test.
    "learned": {"dgpmp2.plan": 1, "dgpmp2.encoder": 1, "dgpmp2.head": N,
                "dgpmp2.residuals": 3 * N + 2, "dgpmp2.assemble": N,
                "dgpmp2.solve": N, "dgpmp2.errors": 3 * N + 1,
                "dgpmp2.update": N},
}


def _profiled(run):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    spans = [e for e in prof.events() if e.name.startswith("dgpmp2.")]
    return out, spans


def _chain(event):
    names = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        names.append(event.name)
    return names


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_the_stage_spans_nest_under_the_plan_as_often_as_the_loop_runs(
        case):
    """Every span's instances (``COUNTS``: the plan once, the residuals at
    the seed and at each proposal, assembly, solve and update once an
    iteration, the learned encoder once and its head once an iteration),
    every stage's parent the plan, and the outputs the same bits as
    without the profiler."""
    run = PLANS[case]()
    want = run()
    got, spans = _profiled(run)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert collections.Counter(e.name for e in spans) == COUNTS[case]
    for e in spans:
        want_chain = [] if e.name == "dgpmp2.plan" else ["dgpmp2.plan"]
        assert [n for n in _chain(e) if n.startswith("dgpmp2.")] == \
            want_chain, e.name
        if want_chain:
            assert e.cpu_parent.name == "dgpmp2.plan", e.name


def test_the_plan_span_records_the_counts_at_its_boundary():
    """With ``record_shapes`` the plan span carries B, T+1, D, the dtype,
    the engine, the method, the iterations and the path (a CPU plan runs
    the eager loop)."""
    run = PLANS["standard"]()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        run()
    plan = next(e for e in prof.events() if e.name == "dgpmp2.plan")
    assert plan.kwinputs == {"B": 3, "T+1": 9, "D": 4,
                             "dtype": "torch.float64", "engine": "standard",
                             "method": "gauss_newton", "max_iters": ITERS,
                             "graph": "eager"}


def _tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "profile_torch_plan.py"
    spec = importlib.util.spec_from_file_location("profile_torch_plan", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_tool_puts_each_device_operation_to_the_span_it_was_launched_in():
    """``tools/profile_torch_plan.spans`` on a hand-made event list: a
    device operation belongs to the spans whose host interval holds its
    runtime call (matched by id), copies are not kernels, and the plan's
    device interval runs from its first operation to its last."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, i, t0, t1):
        return NS(name=name, device_type=dev, id=i,
                  time_range=NS(start=t0, end=t1))

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [ev("dgpmp2.plan", cpu, 1, 0, 100),
              ev("dgpmp2.residuals", cpu, 2, 5, 30),
              ev("dgpmp2.update", cpu, 3, 40, 90),
              ev("cudaLaunchKernel", cpu, 10, 10, 12),
              ev("k1", gpu, 10, 20, 30),
              ev("cudaMemcpyAsync", cpu, 11, 15, 16),
              ev("Memcpy HtoD", gpu, 11, 31, 33),
              ev("cudaLaunchKernel", cpu, 12, 50, 52),
              ev("k2", gpu, 12, 40, 60),
              # Launched inside the plan, outside its stages.
              ev("cudaLaunchKernel", cpu, 13, 95, 96),
              ev("k3", gpu, 13, 70, 75),
              # Launched after the plan.
              ev("cudaLaunchKernel", cpu, 14, 120, 121),
              ev("k4", gpu, 14, 130, 140)]
    table = _tool().spans(events)
    assert table["dgpmp2.plan"] == {
        "count": 1, "host_us": 100, "launches": 3, "device_us": 35.0,
        "interval_us": 55, "idle_us": 55 - 10 - 2 - 20 - 5}
    assert table["dgpmp2.residuals"] == {"count": 1, "host_us": 25,
                                         "launches": 1, "device_us": 10.0}
    assert table["dgpmp2.update"] == {"count": 1, "host_us": 50,
                                      "launches": 1, "device_us": 20.0}


def test_the_tool_reads_every_span_of_a_profiled_plan():
    """On a CPU profile of a plan: each span's instances as the loop opens
    them, and no kernel (the CPU launches none)."""
    run = PLANS["standard"]()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    table = _tool().spans(prof.events())
    assert {k: r["count"] for k, r in table.items()} == COUNTS["standard"]
    assert all(r["launches"] == 0 and r["host_us"] > 0
               for r in table.values())
