"""The differentiable batched planner (port of ``dgpmp2_tpu/planner.py``).

:class:`DiffGPMP2Planner` holds only static configuration and a device;
per-problem state (trajectories, SDFs, start/goal, covariances) flows
through the method arguments as batched tensors.  ``step`` is one batched GN
iteration, ``plan`` (alias ``forward``) the full unrolled optimisation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgpmp2_tpu_torch.core import factors, gn, graph
from dgpmp2_tpu_torch.utils import config as config_lib


class DiffGPMP2Planner:
    """Differentiable batched GPMP2 planner.

    Args mirror the JAX package's constructor (YAML dicts plus a robot),
    with an explicit ``device`` on which every tensor is made.
    """

    def __init__(self, gp_params, obs_params, planner_params, optim_params,
                 env_params, robot, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        self.robot = robot
        self.spec = config_lib.spec_from_params(planner_params, env_params,
                                                robot)
        self.cfg = config_lib.optim_from_params(optim_params)
        gn.resolve_engine(self.cfg.engine)
        self.gp_params = gp_params
        self.obs_params = obs_params
        self.dtype = dtype
        self.device = torch.device(device)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def make_params(self, start, goal) -> graph.GraphParams:
        """Fixed-covariance GraphParams from the YAML scalars for a batch of
        (start, goal) pairs shaped (B, D)."""
        gp, obs = self.gp_params, self.obs_params
        return graph.default_params(
            self.spec, self.robot, self._tensor(start), self._tensor(goal),
            qc_inv=gp["Q_c_inv"], cost_sigma=obs["cost_sigma"],
            epsilon_dist=obs["epsilon_dist"], k_s=gp["K_s"], k_g=gp["K_g"],
            dtype=self.dtype,
        )

    def _with_overrides(self, params, qc_inv_traj=None, q_inv=None,
                        obscov_inv_traj=None, eps_traj=None):
        """Learned/explicit covariance overrides: ``qc_inv_traj``
        (B, T, dof, dof) goes through the GP closed form, ``q_inv``
        (B, T, D, D) is used as given."""
        if qc_inv_traj is not None:
            params = dataclasses.replace(params, q_inv=factors.gp_q_inv(
                self._tensor(qc_inv_traj), self.spec.dt))
        if q_inv is not None:
            params = dataclasses.replace(params, q_inv=self._tensor(q_inv))
        if obscov_inv_traj is not None:
            params = dataclasses.replace(
                params, obs_inv=self._tensor(obscov_inv_traj))
        if eps_traj is not None:
            params = dataclasses.replace(params, eps=self._tensor(eps_traj))
        return params

    def step(self, th, start, goal, sdf, qc_inv_traj=None, q_inv=None,
             obscov_inv_traj=None, eps_traj=None):
        """One batched GN iteration: ``(dtheta, err, err_ext, params)`` with
        ``err`` detached and ``err_ext`` carrying gradients (fixed
        covariances)."""
        params_fix = self.make_params(start, goal)
        params = self._with_overrides(params_fix, qc_inv_traj, q_inv,
                                      obscov_inv_traj, eps_traj)
        th = self._tensor(th)
        sdf = self._tensor(sdf)
        dth = gn.gn_step(self.spec, self.robot, params, th, sdf,
                         delta=self.cfg.reg)
        res = graph.eval_residuals(self.spec, self.robot, params, th, sdf)
        err = graph.error_from_residuals(self.spec, params, res).detach()
        err_ext = graph.error_from_residuals(
            self.spec, params, res, q_inv=params_fix.q_inv,
            obs_inv=params_fix.obs_inv)
        return dth, err, err_ext, params

    def plan(self, th_init, start, goal, sdf, qc_inv_traj=None, q_inv=None,
             obscov_inv_traj=None, eps_traj=None) -> gn.PlanResult:
        """Full unrolled batched plan, differentiable end to end."""
        params_fix = self.make_params(start, goal)
        params = self._with_overrides(params_fix, qc_inv_traj, q_inv,
                                      obscov_inv_traj, eps_traj)
        return gn.plan(self.spec, self.robot, params, self._tensor(th_init),
                       self._tensor(sdf), self.cfg, params_fix=params_fix)

    forward = plan

    def error_batch(self, th, start, goal, sdf) -> torch.Tensor:
        params = self.make_params(start, goal)
        return graph.graph_error(self.spec, self.robot, params,
                                 self._tensor(th), self._tensor(sdf)).detach()

    def error_ext_batch(self, th, start, goal, sdf) -> torch.Tensor:
        params = self.make_params(start, goal)
        return graph.graph_error(self.spec, self.robot, params,
                                 self._tensor(th), self._tensor(sdf))
