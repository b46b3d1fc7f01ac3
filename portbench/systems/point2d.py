"""The 2-D point-robot GPMP2 planner: ``DiffGPMP2Planner.plan`` of the
port, a batch of problems a call, every iteration of the configuration run
(problems that converge are frozen, not dropped)."""
from __future__ import annotations

import numpy as np
import torch

from portbench import systems
from portbench.reference import compare, gpmp2


def problem(config: dict, sdf, start, goal, dtype) -> gpmp2.Problem:
    """The reference's problem of the configuration's fixed factors."""
    gp, obs = config["gp_params"], config["obs_params"]
    env = config["env"]
    dt = (float(config["planner_params"]["total_time_sec"])
          / int(config["planner_params"]["total_time_step"]))
    qc = torch.tensor(gp["Q_c_inv"], dtype=dtype, device=sdf.device)
    return gpmp2.Problem(
        sdf=sdf.to(dtype), start=start.to(dtype), goal=goal.to(dtype),
        q_inv=gpmp2.gp_q_inv(qc, dt), ks_inv=1.0 / float(gp["K_s"]) ** 2,
        kg_inv=1.0 / float(gp["K_g"]) ** 2,
        obs_w=1.0 / float(obs["cost_sigma"]) ** 2,
        eps=float(obs["epsilon_dist"]),
        radius=float(config["robot"]["sphere_radius"][0]), dt=dt,
        x_lims=tuple(env["x_lims"]), y_lims=tuple(env["y_lims"]))


class Driver(systems.Driver):
    OUTPUTS = {"th": 0, "err_init": 0, "err1": 0, "err_final": 0}

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
        from dgpmp2_tpu_torch.utils.config import make_robot

        c = self.config
        gp = dict(c["gp_params"], Q_c_inv=np.asarray(c["gp_params"]["Q_c_inv"]))
        self.planner = DiffGPMP2Planner(
            gp, dict(c["obs_params"]), dict(c["planner_params"]),
            dict(c["optim_params"]), dict(c["env"]), make_robot(c["robot"]),
            dtype=self.dtype, device=device)

    def entry(self, inputs: dict) -> dict:
        with torch.no_grad():
            res = self.planner.plan(inputs["th0"], inputs["start"],
                                    inputs["goal"], inputs["sdf"])
        return {"th": res.th, "err_init": res.err_init,
                "err1": res.err_per_iter[0], "err_final": res.err_final}

    def release(self) -> None:
        self.planner = None

    def check(self, records: list, n: int, block: int) -> dict:
        idx, out = self.sample(records, n)
        pool, f64 = self.pool, torch.float64
        op = self.config["optim_params"]
        blocks = []
        for s in range(0, idx.numel(), block):
            rows = idx[s:s + block]
            inputs = pool.inputs(rows, self.horizon, self.steps)
            p = problem(self.config, inputs["sdf"], inputs["start"],
                        inputs["goal"], f64)
            part = {k: v[s:s + block].to(self.device) for k, v in out.items()}
            blocks.append(compare.point2d(
                p, inputs["th0"], part, float(op["reg"]), self.iters,
                float(op["tol_delta"])))
        return compare.finish(blocks)


def reference_entry(driver: Driver, dtype: torch.dtype):
    """The control's entry: the reference's plan in ``dtype`` in the
    program's place, with the configuration's iterations."""
    op = driver.config["optim_params"]

    def entry(inputs: dict) -> dict:
        p = problem(driver.config, inputs["sdf"], inputs["start"],
                    inputs["goal"], dtype)
        th, err0, errs, _ = gpmp2.plan(p, inputs["th0"].to(dtype),
                                       float(op["reg"]), driver.iters,
                                       float(op["tol_delta"]))
        return {"th": th, "err_init": err0, "err1": errs[0],
                "err_final": errs[-1]}

    return entry
