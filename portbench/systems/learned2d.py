"""The dGPMP2 learned planner: ``LearnedDiffGPMP2Planner.plan`` of the port
with its feed-forward head, the encoder once a call, ``track_best`` kept.

The weights are random, made on the device from the seed in one draw and
scaled leaf by leaf as random weights about the static initialisation:
kernels N(0, 1/fan_in), biases N(0, 0.01), LayerNorm scales 1 + N(0,
0.01); the head's output kernel and the noise on its bias scaled by
``out_scale``, its bias about the static covariances.  Both sides get
these tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import pool as pool_lib
from portbench import systems
from portbench.reference import compare, learned
from portbench.systems import point2d


def out_dim(steps: int) -> int:
    return steps + 2 * (steps + 1)


def make_weights(config: dict, seed: int, device, dtype) -> dict:
    lc, w = config["learned"], config["weights"]
    steps = int(config["planner_params"]["total_time_step"])
    shapes = learned.weight_shapes(2, int(config["env"]["im_size"]),
                                   steps + 1, out_dim(steps))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(
        pool_lib.torch_seed(seed, pool_lib.WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    scale = float(w["out_scale"])
    bias0 = torch.tensor(learned.static_bias(
        steps, *lc["static_init"], float(lc["eps_max"])), dtype=dtype,
        device=device)
    out = {}
    for (name, shape), z in zip(shapes.items(), torch.split(flat, sizes)):
        z = z.view(shape)
        if name.endswith("weight") and len(shape) > 1:
            z = z / float(np.prod(shape[1:])) ** 0.5
        elif ".norms." in name and name.endswith("weight"):
            z = 1.0 + w["noise"] * z
        else:
            z = w["noise"] * z
        if name.startswith("head.out."):
            z = z * scale + (bias0 if name.endswith("bias") else 0.0)
        out[name] = z.contiguous()
    return out


class Driver(systems.Driver):
    OUTPUTS = {"th": 0, "th_final": 0, "errs": 1, "errs_ext": 1}

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from dgpmp2_tpu_torch.core import graph
        from dgpmp2_tpu_torch.learn.learned_planner import (
            LearnedDiffGPMP2Planner, LearnedPlannerConfig)
        from dgpmp2_tpu_torch.utils import config as config_lib

        c, lc = self.config, self.config["learned"]
        robot = config_lib.make_robot(c["robot"])
        spec = config_lib.spec_from_params(c["planner_params"], c["env"], robot)
        self.planner = LearnedDiffGPMP2Planner(
            spec, robot, config_lib.optim_from_params(c["optim_params"]),
            LearnedPlannerConfig(
                dynamics_mode=lc["dynamics_mode"], learn_eps=lc["learn_eps"],
                eps_max=lc["eps_max"], static_init=tuple(lc["static_init"]),
                model_type=lc["model_type"], dropout_prob=lc["dropout_prob"],
                sdf_predict=lc["sdf_predict"], dtype=self.dtype),
            device=device)
        self.weights = make_weights(c, seed, device, self.dtype)
        probe = self.pool.inputs(torch.arange(1, device=device), self.horizon,
                                 self.steps)
        stack = self.planner.stack_inputs(self.pool.maps[:1], probe["sdf"])
        self.variables = self.planner.load_variables(self.weights, stack,
                                                     probe["th0"])
        cov = c["obs_params"]
        self._params = lambda start, goal: graph.default_params(
            spec, robot, start, goal,
            qc_inv=np.asarray(c["gp_params"]["Q_c_inv"]),
            cost_sigma=cov["cost_sigma"], epsilon_dist=cov["epsilon_dist"],
            k_s=c["gp_params"]["K_s"], k_g=c["gp_params"]["K_g"],
            dtype=self.dtype)

    @property
    def encoder(self):
        """The module whose forward the per-layer encoder metric times."""
        return None if self.variables is None else self.variables["conv"]

    def entry(self, inputs: dict) -> dict:
        im = self.pool.maps.index_select(0, inputs["world"])
        with torch.no_grad():
            params = self._params(inputs["start"], inputs["goal"])
            th, errs, errs_ext, _, th_final = self.planner.plan(
                self.variables, params, inputs["th0"], inputs["sdf"], im,
                max_iters=self.iters, track_best=True, return_final=True)
        return {"th": th, "th_final": th_final, "errs": errs,
                "errs_ext": errs_ext}

    def release(self) -> None:
        self.planner = self.variables = None

    def check(self, records: list, n: int, block: int) -> dict:
        idx, out = self.sample(records, n)
        f64 = torch.float64
        w = {k: v.to(f64) for k, v in self.weights.items()}
        op, lc = self.config["optim_params"], self.config["learned"]
        blocks = []
        for s in range(0, idx.numel(), block):
            rows = idx[s:s + block]
            inputs = self.pool.inputs(rows, self.horizon, self.steps)
            fixed = point2d.problem(self.config, inputs["sdf"],
                                    inputs["start"], inputs["goal"], f64)
            im = self.pool.maps.index_select(0, inputs["world"]).to(f64)
            part = {k: (v.narrow(self.OUTPUTS[k], s, rows.numel())
                        .to(self.device)) for k, v in out.items()}
            blocks.append(compare.learned2d(
                w, fixed, im, inputs["th0"], part, float(op["reg"]),
                self.iters, float(lc["eps_max"])))
        return compare.finish(blocks)


def reference_entry(driver: Driver, dtype: torch.dtype):
    """The control's entry: the reference's learned plan in ``dtype`` on the
    same weights, in the program's place."""
    op, lc = driver.config["optim_params"], driver.config["learned"]
    w = {k: v.to(dtype) for k, v in driver.weights.items()}

    def entry(inputs: dict) -> dict:
        fixed = point2d.problem(driver.config, inputs["sdf"], inputs["start"],
                                inputs["goal"], dtype)
        im = driver.pool.maps.index_select(0, inputs["world"]).to(dtype)
        th, errs, errs_ext, th_final = learned.plan(
            w, fixed, im, inputs["th0"].to(dtype), float(op["reg"]),
            driver.iters, float(lc["eps_max"]))
        return {"th": th, "th_final": th_final, "errs": errs,
                "errs_ext": errs_ext}

    return entry

