"""Tracing and timing utilities.

Port of ``dgpmp2_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) under a
  directory, with the card's kernels when the run has a card.
* :func:`annotate`: a named range on the profiler's own timeline, so that
  a phase shows up by name in a trace (names nest), and the kernels
  launched inside it are counted to it.
* :func:`time_compiled`: milliseconds per iteration of ``carry =
  step_fn(carry, *args)``.  The JAX package folds the iterations into one
  compiled ``fori_loop``; here, on a CUDA carry, :class:`CapturedSteps`
  captures ``iters`` dependent steps in one ``torch.cuda.CUDAGraph`` and
  each replay is timed with CUDA events, so that the host's launch work
  is out of the window.  On the CPU it is a plain loop timed with
  ``time.perf_counter``.

Capture runs the Python of ``step_fn`` once: every kernel wrapper's launch
counter (``ops/cuda/*.launches``) goes up once per captured launch, at
capture, where nothing runs, and not at a replay.  :func:`capture`, which
:class:`CapturedSteps` and the captured loops of ``core.gn`` share, takes
those counts back and returns them as the graph's launches a replay
(:func:`counters`, :func:`add_counts`): the counters count the kernels
launched eagerly, and a caller that needs a graph's kernels over n
replays reads its launches × n (``core.gn.graph_launches`` sums them for
the captured plans).  A step that
can be captured never waits for the host: no ``.item()``, ``.cpu()``,
branch on a device value, or tensor made on the card from a Python value
(``torch.tensor(0.1, device="cuda")`` is a host-to-device copy; pass such
constants as tensors made before).  The GN step (``core.gn.gn_step``) is
such a step when its damping is a tensor.  Every kernel is built, and the
SDF split into limbs under a limb engine (``ops.sdf.LIMB_CACHE``), by the
warm-up step that runs before the capture: ``nvcc`` cannot run inside one.

The GN loops open these spans (:func:`annotate`), each a stage of the plan
nested directly under ``dgpmp2.plan``; none is opened per iteration:

* ``dgpmp2.plan``: a whole ``core.gn.plan`` or ``LearnedDiffGPMP2Planner.
  plan``; its arguments (recorded with ``record_shapes``) are B, T+1, D,
  the dtype, the engine, the method, the iterations and the path,
  ``graph``: ``eager``, ``capture`` or ``replay``.  A replay opens this
  span alone (the learned plan's also ``dgpmp2.encoder``, which runs
  eagerly): its loop's kernels run inside one graph launch, and none of
  the stage spans below opens.
* ``dgpmp2.residuals``: the factor graph at a trajectory (forward
  kinematics, the SDF lookup, the hinge), at the seed and at each
  proposal θ + dθ, which it forms.
* ``dgpmp2.assemble``: the block system and its damping (standard engine).
* ``dgpmp2.solve``: the block-tridiagonal solve; under the stream and df32
  engines the one fused step, assembly included.
* ``dgpmp2.errors``: the weighted and the external errors and the
  best-iterate score.
* ``dgpmp2.update``: accept or reject, the masked update, LM's λ,
  convergence, the iteration count; a second instance an iteration keeps
  the best iterate under ``track_best``.
* ``dgpmp2.encoder`` (once a learned plan) and ``dgpmp2.head`` (the head
  and the covariance decode, once a learned iteration).

When no profiler runs a span costs one flag check: :func:`annotate`
returns one shared no-op context and builds nothing.  A span is a
function-scope ``RecordFunction``: the profiler times it on the host and
puts the kernels launched inside it to it (``device_time_total``), and,
unlike ``torch.profiler.record_function``'s user scope, it adds no event of
its own to the device's timeline, where it would read as a device
operation.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Callable

import torch

from dgpmp2_tpu_torch.utils.tree import leaves, tree_map

_KERNEL_MODULES = ("btd_solve", "btd_stream", "sdf_lookup", "sdf_lookup3d",
                   "sdf_lookup_limbs", "sdf_lookup_bwd", "encoder_norm")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (host and, with a card, device
    activity) and write ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def annotate(name: str, args: dict | None = None):
    """A profiler range ``name`` around the enclosed block (see the module
    docstring), with ``args`` (values of int, float or str; others
    formatted) recorded beside it; with no profiler running, the shared
    no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if args is None:
        return torch._C._profiler._RecordFunctionFast(name)
    return torch._C._profiler._RecordFunctionFast(name, (), {
        k: v if isinstance(v, (int, float, str)) else str(v)
        for k, v in args.items()})


def _kernel(name: str):
    return importlib.import_module(f"dgpmp2_tpu_torch.ops.cuda.{name}")


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    return {n: _kernel(n).launches for n in _KERNEL_MODULES}


def counters() -> dict:
    """Every counter of the kernel wrappers: :func:`launch_counts`, K-BTD's
    launches by regime (``btd_solve.<regime>``) and K-LOOKUP-LIMB's SDF
    splits (``sdf_lookup_limbs.splits``)."""
    out = launch_counts()
    for regime, n in _kernel("btd_solve").regime_launches.items():
        out[f"btd_solve.{regime}"] = n
    out["sdf_lookup_limbs.splits"] = _kernel("sdf_lookup_limbs").splits
    return out


def add_counts(delta: dict) -> None:
    """Add ``delta`` (keys of :func:`counters`) to the counters."""
    for key, n in delta.items():
        name, _, sub = key.partition(".")
        mod = _kernel(name)
        if not sub:
            mod.launches += n
        elif sub == "splits":
            mod.splits += n
        else:
            mod.regime_launches[sub] += n


def capture(run: Callable, capturing):
    """``run()`` inside ``capturing`` (a ``torch.cuda.graph`` context): its
    output, and the kernels that one replay of the graph launches, by
    counter of :func:`counters` (those that launched).  Nothing runs at
    capture, so the counts it took are taken back."""
    before = counters()
    try:
        with capturing:
            out = run()
    finally:
        after = counters()
        add_counts({k: before[k] - after[k] for k in after})
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


class CapturedSteps:
    """``iters`` dependent steps ``carry = step_fn(carry, *args)`` of a
    CUDA carry (a tensor, or tuples, lists and dicts of them) captured in
    one ``torch.cuda.CUDAGraph``.

    ``carry`` is the static input buffer (a copy of ``carry_init``): a
    replay runs the steps from it and copies their result back into it,
    so that replays continue one another.  ``args`` stay referenced as
    they are: the graph reads their memory, so change them only in place.
    One warm-up step runs first on a side stream (kernel builds, launch
    plans, the allocator's pool) and is discarded.  ``launches`` holds the
    kernel launches one replay makes, by counter (:func:`capture`); the
    counters count none of them.
    """

    def __init__(self, step_fn: Callable, carry_init, *args,
                 iters: int = 50):
        self.iters = iters
        self.args = args
        self.carry = tree_map(torch.clone, carry_init)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step_fn(tree_map(torch.clone, carry_init), *args)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()

        def steps():
            out = self.carry
            for _ in range(iters):
                out = step_fn(out, *args)
            for dst, src in zip(leaves(self.carry), leaves(out)):
                dst.copy_(src)

        _, self.launches = capture(steps, torch.cuda.graph(self.graph))

    def replay(self):
        """Run the captured steps once (asynchronously); returns the
        carry buffer."""
        self.graph.replay()
        return self.carry


def time_compiled(step_fn: Callable, carry_init, *args, iters: int = 50,
                  repeats: int = 3) -> float:
    """Milliseconds per iteration of ``carry = step_fn(carry, *args)``: the
    best of ``repeats`` runs of ``iters`` dependent steps, after one
    untimed run.  A CUDA carry runs as the replay of a
    :class:`CapturedSteps` graph between two CUDA events; any other as a
    plain loop timed with ``time.perf_counter``."""
    if leaves(carry_init)[0].device.type == "cuda":
        steps = CapturedSteps(step_fn, carry_init, *args, iters=iters)
        steps.replay()
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best / iters

    def run(carry):
        for _ in range(iters):
            carry = step_fn(carry, *args)
        return carry

    carry = run(carry_init)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        carry = run(carry)
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e3
