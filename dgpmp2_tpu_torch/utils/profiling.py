"""Tracing and timing utilities.

Port of ``dgpmp2_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) under a
  directory, with the card's kernels when the run has a card.
* :func:`annotate`: ``torch.profiler.record_function``, so that a phase
  shows up by name in a trace (names nest).
* :func:`time_compiled`: milliseconds per iteration of ``carry =
  step_fn(carry, *args)``.  The JAX package folds the iterations into one
  compiled ``fori_loop``; here, on a CUDA carry, :class:`CapturedSteps`
  captures ``iters`` dependent steps in one ``torch.cuda.CUDAGraph`` and
  each replay is timed with CUDA events, so that the host's launch work
  is out of the window.  On the CPU it is a plain loop timed with
  ``time.perf_counter``.

Capture runs the Python of ``step_fn`` once: every kernel wrapper's launch
counter (``ops/cuda/*.launches``) goes up once per captured launch, at
capture, where nothing runs, and not at a replay.  The capture's count
thus stands for one replay; a caller that checks exact launch counts over
n replays adds ``CapturedSteps.launches`` × (n − 1) itself.  A step that
can be captured never waits for the host: no ``.item()``, ``.cpu()``,
branch on a device value, or tensor made on the card from a Python value
(``torch.tensor(0.1, device="cuda")`` is a host-to-device copy; pass such
constants as tensors made before).  The GN step (``core.gn.gn_step``) is
such a step when its damping is a tensor.  Every kernel is built, and the
SDF split into limbs under a limb engine (``ops.sdf.LIMB_CACHE``), by the
warm-up step that runs before the capture: ``nvcc`` cannot run inside one.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Callable

import torch

from dgpmp2_tpu_torch.utils.tree import leaves, tree_map

_KERNEL_MODULES = ("btd_solve", "sdf_lookup", "sdf_lookup3d",
                   "sdf_lookup_limbs", "sdf_lookup_bwd")


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


def annotate(name: str):
    return torch.profiler.record_function(name)


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    return {n: importlib.import_module(f"dgpmp2_tpu_torch.ops.cuda.{n}")
            .launches for n in _KERNEL_MODULES}


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
    kernel launches one replay makes, by kernel (see the module
    docstring).
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
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = self.carry
            for _ in range(iters):
                out = step_fn(out, *args)
            for dst, src in zip(leaves(self.carry), leaves(out)):
                dst.copy_(src)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}

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
