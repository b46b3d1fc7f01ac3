"""Drivers of the program, one module per configuration's ``system``.

A driver builds the program's planner from the configuration file's values
(never from the program's own YAMLs), makes the cell's pool, runs the timed
call, and hands a sample of the window's answers to the reference.  Its
``entry`` is the one place where the program is called; the control puts
the reference there in a lower precision.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import pool as pool_lib


@dataclasses.dataclass
class Record:
    """One call: its problems, its latency and its answers, copied to the
    host."""

    idx: torch.Tensor
    seconds: float
    out: dict


class Driver:
    """The timed path of a cell: draw, gather, seed, plan, copy to host."""

    # Names of the entry's outputs that the check reads, with the axis that
    # runs over the batch.
    OUTPUTS: dict = {}

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.device = device
        self.dtype = getattr(torch, self.config["dtype"])
        pp = self.config["planner_params"]
        self.horizon = float(pp["total_time_sec"])
        self.steps = int(pp["total_time_step"])
        self.iters = int(self.config["optim_params"]["max_iters"])
        self.pool = pool_lib.Pool(self.config, cell.traffic, seed, device)

    def entry(self, inputs: dict) -> dict:
        raise NotImplementedError

    def call(self, call: int) -> Record:
        t0 = time.perf_counter()
        idx = torch.from_numpy(self.pool.draw(call)).to(self.device)
        inputs = self.pool.inputs(idx, self.horizon, self.steps)
        out = {k: v.cpu() for k, v in self.entry(inputs).items()}
        return Record(idx, time.perf_counter() - t0, out)

    def sample(self, records: list, n: int) -> tuple:
        """``n`` answers of the window (all, if it has fewer), drawn from
        the seed: the pool indices (device) and each output's rows."""
        sizes = [r.idx.numel() for r in records]
        total = sum(sizes)
        pick = torch.from_numpy(np.sort(pool_lib.rng(
            self.seed, pool_lib.CHECK).permutation(total)[:min(n, total)]))
        idx, out = [], {name: [] for name in self.OUTPUTS}
        start = 0
        for r, size in zip(records, sizes):
            rows = pick[(pick >= start) & (pick < start + size)] - start
            start += size
            if rows.numel():
                idx.append(r.idx.cpu()[rows])
                for name, axis in self.OUTPUTS.items():
                    out[name].append(r.out[name].index_select(axis, rows))
        return (torch.cat(idx).to(self.device),
                {name: torch.cat(v, dim=self.OUTPUTS[name])
                 for name, v in out.items()})

    def failed(self, records: list) -> int:
        """Problems whose returned trajectory is not finite."""
        return int(sum(int((~torch.isfinite(r.out["th"]).flatten(1).all(-1))
                           .sum()) for r in records))

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
