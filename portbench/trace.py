"""The traced run's reading of ``torch.profiler``: device operations, their
union, named host ranges, and the host's work in the device's idle gaps.

Profiles a fixed number of whole calls.  The harness opens a host range of
its own (``record_function``) around the encoder's forward (pre- and
post-hooks on the module) and reads its device time from the kernels
launched inside it.  Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

ENCODER = "portbench.encoder"
RANGES = (ENCODER,)
COPIES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read.

    window_s: host time of the profiled calls; ops: device operations
    (name, start µs, duration µs), copies and fills included, kernels the
    rest; ranges: device µs of the kernels launched inside each named host
    range, and how many times it opened; calls, iterations: the profiled
    calls and the GN iterations they ran; gaps: host op -> idle µs."""

    window_s: float
    ops: list
    ranges: dict
    range_counts: dict
    calls: int
    iterations: int
    gaps: dict
    info: dict

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if not o[0].startswith(COPIES)]

    @property
    def busy_s(self) -> float:
        return union_us([(s, s + d) for _, s, d in self.ops]) / 1e6

    def device_us(self, fragment: str) -> tuple:
        """(launches, device µs) of the kernels whose name holds
        ``fragment``."""
        mine = [d for n, _, d in self.kernels if fragment in n]
        return len(mine), float(sum(mine))


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, host) -> dict:
    """Idle device time between the first and the last operation, each gap
    put down to the innermost host op running at its middle (launches and
    other runtime calls skipped for the op that made them); "python" where
    none runs.  ``host``: (start, end, name) of host ops."""
    host = sorted(h for h in host if not h[2].startswith("cuda"))
    starts = [h[0] for h in host]
    out: dict = collections.defaultdict(float)
    end = None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid) - 1
            name = "python"
            for j in range(i, max(i - 256, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            out[name] += s - end
        end = e if end is None else max(end, e)
    return dict(out)


def _top(pairs: dict, n: int = 10) -> list:
    return [[k, v / 1e6] for k, v in sorted(pairs.items(),
                                             key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time and the longest idle
    time by what the host was doing, ten of each, in seconds."""
    ops: dict = collections.defaultdict(float)
    for name, _, dur in trace.ops:
        ops[name[:160]] += dur
    return {"device_ops": _top(ops), "idle_gaps": _top(trace.gaps)}


class _Hooks:
    """A named host range around every forward of a module."""

    def __init__(self, module, name):
        self.name, self.open = name, []
        self.handles = [] if module is None else [
            module.register_forward_pre_hook(self._enter),
            module.register_forward_hook(self._exit)]

    def _enter(self, *_):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self.open.append(rf)

    def _exit(self, *_):
        self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def profile(driver, calls: list, sync) -> tuple:
    """Run ``calls`` of ``driver`` under the profiler: (records, Trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if driver.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    hooks = _Hooks(getattr(driver, "encoder", None), ENCODER)
    records = []
    try:
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in calls:
                records.append(driver.call(i))
            sync()
            window_s = time.perf_counter() - t0
    finally:
        hooks.remove()
    events = prof.events()
    ops, host = [], []
    ranges = dict.fromkeys(RANGES, 0.0)
    counts = dict.fromkeys(RANGES, 0)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in RANGES:
                ops.append((e.name, start, end - start))
        elif e.name in RANGES:
            ranges[e.name] += _device_us(e)
            counts[e.name] += 1
        elif not e.is_async:
            host.append((start, end, e.name))
    gaps = idle_gaps([(s, s + d) for _, s, d in ops], host)
    trace = Trace(window_s=window_s, ops=ops, ranges=ranges,
                  range_counts=counts, calls=len(calls),
                  iterations=len(calls) * driver.iters, gaps=gaps,
                  info=driver_info(driver))
    return records, trace


def _device_us(event) -> float:
    """Device µs of the kernels launched inside a host range (the name of
    the property moved between torch versions)."""
    for name in ("device_time_total", "cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def driver_info(driver) -> dict:
    """The shapes a reader's counts need."""
    cfg = driver.config
    return {"batch": driver.pool.batch, "steps": driver.steps,
            "state_dim": int(cfg["planner_params"]["state_dim"]),
            "iters": driver.iters, "dtype": cfg["dtype"]}
