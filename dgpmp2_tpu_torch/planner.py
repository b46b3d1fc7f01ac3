"""High-level planner APIs (port of ``dgpmp2_tpu/planner.py``).

* :class:`DiffGPMP2Planner`, the differentiable batched planner: ``step``
  is one batched GN iteration, ``plan`` (alias ``forward``) the full
  unrolled optimisation, and ``error_batch`` / ``error_ext_batch`` /
  ``linear_error`` / ``unweighted_errors_batch`` the error functionals.
* :class:`GPMP2Planner`, the classic non-differentiable planner: a host loop
  of GN or LM steps with a convergence exit, a wall-clock ``plan_time``
  budget, per-problem LM lambdas and step rejection, plus batched
  multistart.

Planners hold only static configuration and a device; per-problem state
(trajectories, SDFs, start/goal, covariances) flows through the method
arguments as batched tensors.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.core import factors, gn, graph
from dgpmp2_tpu_torch.utils import config as config_lib


class DiffGPMP2Planner:
    """Differentiable batched GPMP2 planner.

    Args mirror the JAX package's constructor (YAML dicts plus a robot and
    the optional learn-params dict), with the ``device`` on which every
    tensor is made: the card (``cuda``) unless ``device="cpu"`` is given.
    There is no fallback: without a card the first tensor made raises.
    """

    def __init__(self, gp_params, obs_params, planner_params, optim_params,
                 env_params, robot, learn_params=None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        self.robot = robot
        self.spec = config_lib.spec_from_params(planner_params, env_params,
                                                robot)
        self.cfg = config_lib.optim_from_params(optim_params)
        gn.resolve_engine(self.cfg.engine)
        self.gp_params = gp_params
        self.obs_params = obs_params
        self.learn_params = learn_params
        self.dtype = dtype
        self.device = torch.device("cuda" if device is None else device)
        self.dynamics_mode = (
            learn_params["dgpmp2"]["dynamics_mode"] if learn_params else None
        )

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def make_params(self, start, goal,
                    workspace_goal=None) -> graph.GraphParams:
        """Fixed-covariance GraphParams from the YAML scalars for a batch of
        (start, goal) pairs shaped (B, D); ``workspace_goal`` (B, W) is the
        end-effector target when the spec enables ``use_workspace_goal``."""
        gp, obs = self.gp_params, self.obs_params
        return graph.default_params(
            self.spec, self.robot, self._tensor(start), self._tensor(goal),
            qc_inv=gp["Q_c_inv"], cost_sigma=obs["cost_sigma"],
            epsilon_dist=obs["epsilon_dist"], k_s=gp["K_s"], k_g=gp["K_g"],
            k_d=gp.get("K_d"), k_v=gp.get("K_v"), v_x=gp.get("v_x"),
            v_y=gp.get("v_y"), k_self=gp.get("K_self"),
            eps_self=obs.get("self_collision_eps", 0.05),
            k_jl=gp.get("K_jl"), q_min=gp.get("q_min"), q_max=gp.get("q_max"),
            k_wg=gp.get("K_wg"),
            workspace_goal=(None if workspace_goal is None
                            else self._tensor(workspace_goal)),
            dtype=self.dtype,
        )

    def _with_overrides(self, params, qc_inv_traj=None, q_inv=None,
                        obscov_inv_traj=None, eps_traj=None):
        """Learned/explicit covariance overrides: ``qc_inv_traj``
        (B, T, dof, dof) goes through the GP closed form, ``q_inv``
        (B, T, D, D) is used as given (``dynamics_mode='q_full'``)."""
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

    def linear_error(self, th, start, goal, sdf) -> torch.Tensor:
        """Stacked residual vector (B, M) (``graph.linear_error``)."""
        params = self.make_params(start, goal)
        return graph.linear_error(self.spec, self.robot, params,
                                  self._tensor(th), self._tensor(sdf))

    def unweighted_errors_batch(self, th, start, goal, sdf):
        """``(err_sg, err_gp, err_obs)`` each (B,)
        (``graph.unweighted_errors``)."""
        params = self.make_params(start, goal)
        return graph.unweighted_errors(self.spec, self.robot, params,
                                       self._tensor(th), self._tensor(sdf))


class GPMP2Planner:
    """Classic (non-differentiable) GN / LM planner with host-side control:
    an iteration loop with a convergence exit, a wall-clock ``plan_time``
    budget, and for ``method='lm'`` the 10×/÷10 lambda schedule with
    trust-region diagonal damping and step rejection.  Runs in float64 by
    default, as the JAX package does, on the card unless ``device="cpu"``."""

    def __init__(self, gp_params, obs_params, planner_params, env_params,
                 robot, dtype: torch.dtype = torch.float64,
                 device: torch.device | str | None = None):
        self._diff = DiffGPMP2Planner(
            gp_params, obs_params, planner_params,
            {"method": "gauss_newton", "reg": 0.0, "max_iters": 100},
            env_params, robot, dtype=dtype, device=device,
        )
        self.spec = self._diff.spec
        self.robot = robot
        self.dtype = dtype
        self.device = self._diff.device

    def _tensor(self, x) -> torch.Tensor:
        return self._diff._tensor(x)

    @torch.no_grad()
    def _step(self, params, th, sdf, delta, trust_region: bool):
        dth = gn.gn_step(self.spec, self.robot, params, th, sdf, delta,
                         trust_region=trust_region)
        err_new = graph.graph_error(self.spec, self.robot, params, th + dth,
                                    sdf)
        return dth, err_new

    def _params1(self, start, goal):
        return self._diff.make_params(self._tensor(start)[None],
                                      self._tensor(goal)[None])

    @torch.no_grad()
    def step(self, th, start, goal, sdf, optim_params=None):
        """One GN step on a single problem: ``(dtheta, err_old)``; the caller
        owns the iteration loop."""
        reg = float((optim_params or {}).get("reg", 0.0))
        params = self._params1(start, goal)
        thb = self._tensor(th)[None]
        sdfb = self._tensor(sdf)[None]
        err_old = graph.graph_error(self.spec, self.robot, params, thb, sdfb)
        dth, _ = self._step(params, thb, sdfb, reg, False)
        return dth[0], float(err_old[0])

    @torch.no_grad()
    def error(self, th, start, goal, sdf) -> float:
        """Weighted graph error of one trajectory."""
        return float(graph.graph_error(
            self.spec, self.robot, self._params1(start, goal),
            self._tensor(th)[None], self._tensor(sdf)[None])[0])

    def plan(self, start, goal, th_init, sdf, optim_params=None):
        """Single-problem plan: ``(th, err_init, err_final, err_per_iter,
        iters, time_taken)``."""
        th, err_init, err_final, err_per_iter, iters, dt = self.plan_batch(
            self._tensor(start)[None], self._tensor(goal)[None],
            self._tensor(th_init)[None], self._tensor(sdf)[None],
            optim_params)
        return (th[0], float(err_init[0]), float(err_final[0]),
                [float(e[0]) for e in err_per_iter], int(iters[0]), dt)

    def plan_multistart(self, startb, goalb, th_initb, sdfb,
                        optim_params=None, restarts=8, amp=1.5, seed=0,
                        prune_iters=0, keep=0):
        """Batched multi-start plan: ``restarts`` endpoint-preserving seed
        perturbations per problem (drawn from a ``torch.Generator`` seeded
        with ``seed`` on the planner's device), planned as one (K·B) batch
        and selected per problem; ``prune_iters``/``keep`` enable staged
        pruning (:func:`dgpmp2_tpu_torch.core.multistart.plan_multistart`).
        Returns a ``MultistartResult``."""
        from dgpmp2_tpu_torch.core.multistart import plan_multistart as _ms

        op = optim_params or {}
        cfg = gn.OptimConfig(
            method=op.get("method", "gauss_newton"),
            reg=float(op.get("reg", 0.1)),
            max_iters=int(op.get("max_iters", 50)),
            tol_err=float(op.get("tol_err", 1e-3)),
            tol_delta=float(op.get("tol_delta", 1e-4)),
        )
        params = self._diff.make_params(startb, goalb)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            return _ms(self.spec, self.robot, params,
                       self._tensor(th_initb), self._tensor(sdfb), cfg,
                       generator, restarts=restarts, amp=amp,
                       prune_iters=prune_iters, keep=keep)

    @torch.no_grad()
    def plan_batch(self, startb, goalb, th_initb, sdfb, optim_params=None):
        """Batched classic plan: :meth:`plan` over a leading batch axis, with
        per-problem LM lambdas, step rejection and convergence freezing.
        Every iteration reads the step norms on the host for the
        convergence exit.

        Returns ``(thb (B,T+1,D), err_init (B,), err_final (B,),
        err_per_iter [list of (B,) numpy], iters (B,), time_taken)``.
        """
        if optim_params is None:
            optim_params = {
                "method": "gauss_newton", "plan_time": np.inf,
                "max_iters": 100, "tol_err": 1e-2, "tol_delta": 1e-3,
                "reg": 0.0,
            }
        lm = optim_params.get("method", "gauss_newton") == "lm"
        plan_time = config_lib.plan_time_budget(optim_params)
        max_iters = float(optim_params.get("max_iters", np.inf))
        tol_delta = float(optim_params.get("tol_delta", 1e-3))
        reg = float(optim_params.get("reg", 0.0))

        th = self._tensor(th_initb)
        sdfb = self._tensor(sdfb)
        b = th.shape[0]
        params = self._diff.make_params(startb, goalb)
        err_old = graph.graph_error(self.spec, self.robot, params, th, sdfb)
        err_init = err_old.cpu().numpy().copy()
        lam = torch.full((b,), 1e-4, dtype=self.dtype, device=self.device)
        conv = np.zeros((b,), bool)
        iters = np.zeros((b,), np.int64)
        err_per_iter = []
        start_t = time.time()
        j = 0
        while True:
            err_per_iter.append(err_old.cpu().numpy().copy())
            active = torch.as_tensor(~conv, device=self.device)
            if lm:
                dth, err_new = self._step(params, th, sdfb, lam, True)
                accept = err_new < err_old
                take = accept & active
                th = torch.where(take[:, None, None], th + dth, th)
                err_old = torch.where(take, err_new, err_old)
                lam = torch.where(
                    active, torch.where(accept, lam / 10.0, lam * 10.0), lam)
            else:
                dth, err_new = self._step(params, th, sdfb, reg, False)
                th = torch.where(active[:, None, None], th + dth, th)
                err_old = torch.where(active, err_new, err_old)
            j += 1
            dth_norm = torch.linalg.vector_norm(
                dth.reshape(b, -1), dim=-1).cpu().numpy()
            iters += ~conv
            conv = conv | (dth_norm < tol_delta)
            if conv.all() or j >= max_iters:
                break
            if time.time() - start_t > plan_time:
                break
        return (th, err_init, err_old.cpu().numpy(), err_per_iter, iters,
                time.time() - start_t)
