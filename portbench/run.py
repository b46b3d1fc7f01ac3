"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a run, on one CUDA device: set-up (the kernel library, the
pool of problems, the weights) and warm-up calls of the cell's own shapes,
then a closed loop of calls for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or a fixed number of profiled calls (``--trace 1``: its
per-layer metrics), then the reference's check of the answers.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, end standard error and the result line.  Without a CUDA
device, or with JAX loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "dgpmp2_tpu")
CACHE = spec.ROOT / ".portbench_cache"
BUILD = spec.ROOT / "dgpmp2_tpu_torch" / "build"


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN))


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; a
    lock left by a cut-off build is cleared."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    (BUILD / "lock").unlink(missing_ok=True)


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    setup_s: float
    records: list
    window_s: float
    trace: object = None


def _sync(device):
    import torch

    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float = T0) -> tuple:
    """Set up, warm up, run the window or the profiled calls, check:
    (result dict, compared dict).  ``device`` may be the CPU for tests."""
    import torch

    from portbench import trace as trace_lib

    cfg, settings = cell.config, cell.settings
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    sync = _sync(device)
    phases = {"imports": time.perf_counter() - t0}
    driver = spec.system(cfg).Driver(cell, seed, device)
    sync()
    phases["pool and program"] = time.perf_counter() - t0 - sum(phases.values())
    for k in range(int(settings["warmup_calls"])):
        driver.call(-1 - k)
    sync()
    setup_s = time.perf_counter() - t0
    phases["warm-up calls"] = setup_s - sum(phases.values())
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(setup_s=setup_s, records=[], window_s=0.0)
    if traced:
        ctx.records, ctx.trace = trace_lib.profile(
            driver, list(range(int(settings["trace_calls"]))), sync)
        ctx.window_s = ctx.trace.window_s
        metrics = cell.per_layer
    else:
        start = time.perf_counter()
        while not ctx.records or time.perf_counter() - start < seconds:
            ctx.records.append(driver.call(len(ctx.records)))
        ctx.window_s = time.perf_counter() - start
        metrics = cell.end_to_end
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    if traced:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    values = {}
    for m in metrics:
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    ms = sorted(r.seconds * 1e3 for r in ctx.records)
    print(f"window: {len(ms)} calls in {ctx.window_s:.3f} s, batch ms min "
          f"{ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}",
          file=sys.stderr)
    attempted = sum(r.idx.numel() for r in ctx.records)
    failed = driver.failed(ctx.records)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = driver.check(ctx.records, int(settings["check_problems"]),
                            int(settings["check_block"]))
    limits = settings["limits"]
    correct = failed == 0 and all(
        math.isfinite(compared[k]) and compared[k] <= limits[k]
        for k in limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if traced:
        result["breakdown"] = trace_lib.breakdown(ctx.trace)
    result["compared"] = {k: {"value": compared[k], "limit": limits[k]}
                          for k in limits}
    return result, compared


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    set_caches()
    import torch

    torch.set_num_threads(1)  # the host loop is one thread; no pool beside it
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, compared = execute(cell, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"card: {card()}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
