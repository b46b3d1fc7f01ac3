"""A cell's pool of problems, made in set-up from the seed, and the draws
of its calls.

The traffic file names the world family, the bank's number of worlds, the
start-goal pairs on each, and the batch a call plans.  The maps, their
SDFs and the pairs live on the device; a call's draw is ``batch`` distinct
problems of the pool, from a stream of the seed of its own, so every run
of a seed sends the same batches and every seed the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import worlds

# Streams of one seed: the bank, each call's draw, the weights, the sample
# the reference checks.
BANK, DRAW, WEIGHTS, CHECK = 1, 2, 3, 4


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Pool:
    """maps, sdf (worlds, H, W) float32; start, goal (N, 4) float32 with
    zero velocities; world (N,) int64: the world of each problem."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        env = config["env"]
        if traffic["family"] != "forest":
            raise ValueError(f"unknown world family {traffic['family']!r}")
        self.seed = seed
        self.device = device
        self.batch = int(traffic["batch"])
        self.x_lims = tuple(env["x_lims"])
        self.y_lims = tuple(env["y_lims"])
        size = int(env["im_size"])
        self.res = (self.x_lims[1] - self.x_lims[0]) / size
        n_worlds, pairs = int(traffic["worlds"]), int(traffic["pairs_per_world"])
        gen = torch.Generator(device=device).manual_seed(torch_seed(seed, BANK))
        self.maps, starts, goals = worlds.forest_bank(
            gen, n_worlds, pairs, size, self.x_lims, self.y_lims,
            float(config["robot"]["sphere_radius"][0]), device)
        self.sdf = worlds.sdf_from_map(self.maps, self.res)
        n = n_worlds * pairs
        if n < self.batch:
            raise ValueError(f"a pool of {n} problems cannot fill a batch "
                             f"of {self.batch}")
        zero = torch.zeros((n, 2), dtype=torch.float32, device=device)
        self.start = torch.cat([starts.reshape(n, 2).float(), zero], -1)
        self.goal = torch.cat([goals.reshape(n, 2).float(), zero], -1)
        self.world = torch.arange(n_worlds, device=device).repeat_interleave(
            pairs)
        self.size = n

    def draw(self, call: int) -> np.ndarray:
        """The problems of call ``call`` (negative: warm-up calls)."""
        return rng(self.seed, DRAW, call + (1 << 20)).permutation(
            self.size)[:self.batch]

    def inputs(self, idx: torch.Tensor, horizon: float, steps: int) -> dict:
        """A call's inputs on the device: its SDFs, maps, start and goal
        states and straight-line seed trajectories (float32)."""
        world = self.world.index_select(0, idx)
        start = self.start.index_select(0, idx)
        goal = self.goal.index_select(0, idx)
        return {"idx": idx, "world": world,
                "sdf": self.sdf.index_select(0, world),
                "start": start, "goal": goal,
                "th0": worlds.straight_line(start[:, :2], goal[:, :2],
                                            horizon, steps)}
