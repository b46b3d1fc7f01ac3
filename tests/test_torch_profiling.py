"""dgpmp2_tpu_torch.utils.profiling on the CPU: ``time_compiled`` returns a
positive time per iteration and runs the plain loop (its carry equals the
loop's, as ``tests/test_aux.py:133`` times JAX's), ``trace`` writes a
Chrome trace and ``annotate`` nests.  The CUDA-graph capture runs only on
the card (``tests/test_torch_cuda.py``)."""
import json

import jax.numpy as jnp
import pytest
import torch

from dgpmp2_tpu.utils.profiling import time_compiled as j_time_compiled
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.utils import profiling

from _torch_parity import both_problems

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
        "btd_solve", "sdf_lookup", "sdf_lookup3d", "sdf_lookup_limbs",
        "sdf_lookup_bwd"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            profiling.CapturedSteps(lambda c: c, torch.ones(2), iters=1)
