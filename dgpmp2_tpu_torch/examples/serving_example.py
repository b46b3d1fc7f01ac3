"""Concurrent clients through the micro-batching service: port of
``examples/serving_example.py``.  Eight clients submit planning problems at
once; the dispatcher coalesces them into batches of four (two dispatches)
and each client gets the trajectory a direct batched ``plan`` of its batch
gives.  The example holds that count and finite errors, or it raises.

    python -m dgpmp2_tpu_torch.examples.serving_example [--device cpu]
        [--dtype float64] [--plot]
"""
from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.serve import PlanningService, PlanRequest

T, CLIENTS, BATCH, WINDOW_MS = 30, 8, 4, 50.0


def requests(sdf: np.ndarray, dtype) -> list:
    """The clients' problems: the box world's corners, each endpoint moved
    by up to 0.4 m (numpy seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(CLIENTS):
        s = np.array([-4.0, -4.0, 0.0, 0.0], dtype)
        g = np.array([4.0, 4.0, 0.0, 0.0], dtype)
        s[:2] += rng.uniform(-0.4, 0.4, 2)
        g[:2] += rng.uniform(-0.4, 0.4, 2)
        out.append(PlanRequest(start=s, goal=g, sdf=sdf))
    return out


def main(argv=None) -> dict:
    args = _common.parse(_common.parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    env, pp, gp, obs, opt, robot_data = _common.load_configs()
    img, sdf, _ = _common.box_world(dev, dtype)
    sdf = _common.np_(sdf)
    planner = DiffGPMP2Planner(gp, obs, dict(pp, total_time_step=T), opt,
                               _common.env_params(env),
                               make_robot(robot_data), dtype=dtype,
                               device=dev)
    svc = PlanningService(planner, batch_size=BATCH, window_ms=WINDOW_MS)
    print("building the serving path ...")
    t0 = time.perf_counter()
    svc.warmup(sdf.shape)
    print(f"warmed up in {time.perf_counter() - t0:.1f}s")
    reqs = requests(sdf, np_dtype)

    async def clients():
        await svc.start()
        try:
            return await asyncio.gather(*(svc.submit(r) for r in reqs))
        finally:
            await svc.stop()

    responses = asyncio.run(clients())
    for i, r in enumerate(responses):
        print(f"client {i}: err {r.err_init:9.3f} -> {r.err_final:.5f}  "
              f"iters {r.iters}  fill {r.batch_fill:.2f}  "
              f"latency {r.latency_s * 1e3:6.1f} ms")
    dispatches = svc.stats["batches"]
    print(f"dispatches: {dispatches}  ({CLIENTS} requests coalesced into "
          f"batches of {svc.batch_size})")
    if dispatches != CLIENTS // BATCH:
        raise RuntimeError(f"{dispatches} dispatches, not "
                           f"{CLIENTS // BATCH}")
    err_final = np.array([r.err_final for r in responses])
    if not np.isfinite(err_final).all():
        raise RuntimeError(f"non-finite errors {err_final}")
    print("ok")
    if args.plot:
        plot(img, responses)
    return {"dispatches": dispatches,
            "err_init": np.array([r.err_init for r in responses]),
            "err_final": err_final,
            "iters": np.array([r.iters for r in responses]),
            "latency_ms": np.array([r.latency_s * 1e3 for r in responses]),
            "requests": reqs, "th": np.stack([r.th for r in responses])}


def plot(img, responses):
    """Every client's plan over the box world."""
    plt, fig, ax = _common.figure(figsize=(6, 6))
    ax.imshow(img, cmap="gray", extent=(-5, 5, -5, 5), origin="upper")
    for i, r in enumerate(responses):
        ax.plot(r.th[:, 0], r.th[:, 1], "-", lw=1, label=f"client {i}")
    ax.legend(fontsize=7)
    _common.save(plt, fig, "serving_example.png")


if __name__ == "__main__":
    main()
