"""Gauss-Newton / Levenberg-Marquardt engine over the block factor graph.

Port of ``dgpmp2_tpu/core/gn.py``.  :func:`gn_step` is one damped GN update;
:func:`plan` runs a fixed iteration budget as a Python loop of masked
``torch.where`` updates (the JAX package's ``lax.scan``), with per-problem
convergence freezing, so no iteration waits for the host.  The whole plan is
differentiable through the unrolled iterations.  ``err`` (the convergence
metric) is detached; ``err_ext`` (fixed external covariances) carries
gradients.

Three linear-system engines (``OptimConfig.engine``): the standard one,
assembly in ``core/graph.py`` and the solve in ``ops/tridiag.btd_solve_auto``
(the K-BTD kernel for CUDA tensors); the stream engine (``core/stream.py``),
assembly and solve in one kernel, K-STREAM; and df32 (``core/df32.py``),
float32 residuals with a float64 assembly and solve.

:func:`plan` opens the profiler spans of ``utils.profiling`` (``dgpmp2.plan``
and its stages); they cost one flag check when no profiler runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer options (``optim_params`` YAML)."""

    method: str = "gauss_newton"  # or "lm"
    reg: float = 0.1
    max_iters: int = 100
    tol_err: float = 1e-3
    tol_delta: float = 1e-4
    conv_check_dtheta: bool = True
    conv_check_err: bool = False
    lm_lambda_init: float = 1e-4
    # Linear-system engine inside :func:`plan`:
    #   "auto"     - the standard engine, on every device (see resolve_engine).
    #   "standard" - assembly (core/graph.py) + damping + K-BTD solve.
    #   "stream"   - assembly, damping and solve in one K-STREAM launch per
    #                iteration (core/stream.py); its plain version on the CPU.
    #   "df32"     - float32 residuals, float64 assembly and solve
    #                (core/df32.py): steps of float64 quality in a float32
    #                plan; refuses float64 plans, GP interpolation and the
    #                workspace goal.
    engine: str = "auto"


ENGINES = ("auto", "standard", "stream", "df32")


def resolve_engine(engine: str, dtype: torch.dtype | None = None) -> str:
    """Map ``engine`` to a concrete engine; unknown names raise.

    ``auto`` is the standard engine on every device and dtype.  The JAX
    package picks the stream engine on its TPU; which engine the card should
    pick is left to a measurement of both at a benchmark cell.  ``dtype`` is
    taken for the JAX signature and does not change the answer.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return "standard" if engine == "auto" else engine


class PlanResult(NamedTuple):
    th: torch.Tensor  # (B, T+1, D) final trajectories
    err_init: torch.Tensor  # (B,)
    err_final: torch.Tensor  # (B,)
    err_per_iter: torch.Tensor  # (iters, B) weighted error trace
    err_ext_per_iter: torch.Tensor  # (iters, B) external error trace
    iters: torch.Tensor  # (B,) iterations actually used per problem
    # Best non-colliding trajectory by GP-MSE seen along the optimisation;
    # equals `th` where none was non-colliding (track_best only).
    best_th: Optional[torch.Tensor] = None
    best_valid: Optional[torch.Tensor] = None  # (B,) bool


def damped_system(diag, off, rhs, delta, trust_region: bool = False):
    """GN damping ``+δI`` or LM trust-region ``+δ·diag(Λ)``; ``delta`` is a
    scalar or a (B,) per-problem value."""
    d = diag.shape[-1]
    delta = torch.as_tensor(delta, dtype=diag.dtype, device=diag.device)
    while delta.ndim < diag.ndim - 2:
        delta = delta[..., None]
    scale = delta[..., None, None]
    eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
    damp = scale * (eye * diag) if trust_region else scale * eye
    return diag + damp, off, rhs


def gn_step(spec: graph_lib.GraphSpec, robot, params: graph_lib.GraphParams,
            th: torch.Tensor, sdf: torch.Tensor, delta,
            trust_region: bool = False) -> torch.Tensor:
    """One Gauss-Newton update ``dθ = (AᵀKA + δI)⁻¹ AᵀKb`` in block form."""
    diag, off, rhs = graph_lib.assemble(spec, robot, params, th, sdf)
    diag, off, rhs = damped_system(diag, off, rhs, delta, trust_region)
    return tridiag.btd_solve_auto(diag, off, rhs)


def _converged(dth, err_delta, cfg: OptimConfig):
    """Per-problem convergence test."""
    b = dth.shape[0]
    conv = torch.zeros((b,), dtype=torch.bool, device=dth.device)
    if cfg.conv_check_dtheta:
        conv = conv | (torch.linalg.vector_norm(dth.reshape(b, -1), dim=-1)
                       < cfg.tol_delta)
    if cfg.conv_check_err:
        conv = conv | (err_delta.abs() < cfg.tol_err)
    return conv


def _best_score(res: graph_lib.FactorResiduals) -> torch.Tensor:
    """GP-MSE if the interior is collision-free, else +inf.  Collision
    covers the GP-interpolated checks and self-collision where enabled."""
    colliding = torch.any((res.r_obs[..., 1:-1, :] > 0).flatten(-2), dim=-1)
    if res.r_obsi is not None:
        colliding = colliding | torch.any((res.r_obsi > 0).flatten(-3), dim=-1)
    if res.r_self is not None:
        colliding = colliding | torch.any(
            (res.r_self[..., 1:-1, :] > 0).flatten(-2), dim=-1)
    gp_mse = torch.mean(torch.sum(res.r_gp**2, dim=-1), dim=-1)
    return torch.where(colliding, torch.full_like(gp_mse, float("inf")),
                       gp_mse)


def plan(spec: graph_lib.GraphSpec, robot, params: graph_lib.GraphParams,
         th_init: torch.Tensor, sdf: torch.Tensor, cfg: OptimConfig,
         params_fix: Optional[graph_lib.GraphParams] = None,
         track_best: bool = False) -> PlanResult:
    """Batched plan: ``cfg.max_iters`` GN/LM steps with convergence freeze.

    LM keeps one lambda per problem (accepted steps divide it by 10, rejected
    steps multiply it by 10).  ``params_fix`` supplies the fixed external
    covariances of the ``err_ext`` trace; it defaults to ``params``.  The JAX
    package's ``unroll`` (a ``lax.scan`` option) has no counterpart in a
    Python loop and is not taken.
    """
    if cfg.method not in ("gauss_newton", "lm"):
        raise ValueError(
            f"unknown method {cfg.method!r}; expected 'gauss_newton' or 'lm'"
        )
    engine = resolve_engine(cfg.engine, th_init.dtype)
    if engine == "df32" and th_init.dtype != torch.float32:
        raise ValueError("engine='df32' is a float32 accuracy mode; use the "
                         "standard engine for float64 runs")
    if params_fix is None:
        params_fix = params
    b, t1, d = th_init.shape
    with annotate("dgpmp2.plan", {"B": b, "T+1": t1, "D": d,
                                  "dtype": th_init.dtype, "engine": engine,
                                  "method": cfg.method,
                                  "max_iters": cfg.max_iters}):
        return _plan(spec, robot, params, th_init, sdf, cfg, params_fix,
                     track_best, engine)


def _plan(spec, robot, params, th_init, sdf, cfg, params_fix, track_best,
          engine) -> PlanResult:
    """The body of :func:`plan`, its stages in their spans."""
    # The lookup kernels read a contiguous SDF batch; made so once here, a
    # strided one (as sdf_from_occupancy returns) is not copied per lookup.
    sdf = sdf.contiguous()
    b = th_init.shape[0]
    dtype, dev = th_init.dtype, th_init.device
    lm = cfg.method == "lm"

    def residuals(th):
        return graph_lib.eval_residuals(spec, robot, params, th, sdf)

    def weighted_err(res):
        return graph_lib.error_from_residuals(spec, params, res).detach()

    def ext_err(res):
        return graph_lib.error_from_residuals(
            spec, params, res, q_inv=params_fix.q_inv,
            obs_inv=params_fix.obs_inv,
        )

    # One factor-graph evaluation per iteration feeds assembly and both
    # error traces; the GP/prior Gauss blocks are built once.
    with annotate("dgpmp2.residuals"):
        res = residuals(th_init)
    with annotate("dgpmp2.errors"):
        err0 = weighted_err(res)
        if track_best:
            best_s = _best_score(res).detach()
    static = graph_lib.assemble_static(spec, params, dtype)
    if engine in ("stream", "df32"):
        from dgpmp2_tpu_torch.core import df32 as df32_lib
        from dgpmp2_tpu_torch.core import stream as stream_lib

        # The per-plan blocks once, GN's scalar damping folded in (LM's is
        # per problem and per iteration); df32 holds them in float64 (its
        # CPU step, the plain float64 solve, does not read them).
        ss = stream_lib.build_stream_static(
            spec, params, static if engine == "stream" else None, b,
            dtype if engine == "stream" else torch.float64,
            reg=0.0 if lm else cfg.reg)
    th, err_old = th_init, err0
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    lam = torch.full((b,), cfg.lm_lambda_init, dtype=dtype, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    reg = torch.tensor(cfg.reg, dtype=dtype, device=dev)
    if track_best:
        best_th = th_init
    errs, errs_ext = [], []
    for _ in range(cfg.max_iters):
        delta = lam if lm else reg
        if engine == "stream":
            with annotate("dgpmp2.solve"):
                dth = stream_lib.stream_step(spec, params, ss, res, delta,
                                             trust_region=lm)
        elif engine == "df32":
            with annotate("dgpmp2.solve"):
                # GN's damping as the float64 value of cfg.reg, as in ss.
                dth = df32_lib.df32_step_from_residuals(
                    spec, params, res, lam if lm else cfg.reg,
                    trust_region=lm, ss=ss)
        else:
            with annotate("dgpmp2.assemble"):
                diag, off, rhs = graph_lib.assemble_from_residuals(
                    spec, params, res, dtype=dtype, static=static)
                diag, off, rhs = damped_system(diag, off, rhs, delta,
                                               trust_region=lm)
            with annotate("dgpmp2.solve"):
                dth = tridiag.btd_solve_auto(diag, off, rhs)
        with annotate("dgpmp2.residuals"):
            th_prop = th + dth
            res_prop = residuals(th_prop)
        with annotate("dgpmp2.errors"):
            err_prop = weighted_err(res_prop)
        with annotate("dgpmp2.update"):
            accept = (err_prop < err_old) if lm else torch.ones_like(conv)
            take = accept & ~conv
            th = torch.where(take[:, None, None], th_prop, th)
            res = graph_lib.select(take, res_prop, res)
            err_next = torch.where(take, err_prop, err_old)
            if lm:
                lam = torch.where(conv, lam,
                                  torch.where(accept, lam / 10.0, lam * 10.0))
            trigger = _converged(dth, err_next - err_old, cfg)
            if lm:
                # A rejected proposal is not convergence: LM raises lambda
                # and retries instead.
                trigger = trigger & accept
            iters = iters + (~conv).to(torch.int32)
            conv = conv | trigger
            err_old = err_next
            errs.append(err_next)
        with annotate("dgpmp2.errors"):
            errs_ext.append(ext_err(res))
            if track_best:
                s = _best_score(res).detach()
        if track_best:
            with annotate("dgpmp2.update"):
                better = s < best_s
                best_th = torch.where(better[:, None, None], th, best_th)
                best_s = torch.minimum(s, best_s)
    best_valid = None
    if track_best:
        best_valid = torch.isfinite(best_s)
        best_th = torch.where(best_valid[:, None, None], best_th, th)
    else:
        best_th = None

    def trace(xs):
        return (torch.stack(xs) if xs
                else torch.zeros((0, b), dtype=dtype, device=dev))

    return PlanResult(th=th, err_init=err0, err_final=err_old,
                      err_per_iter=trace(errs),
                      err_ext_per_iter=trace(errs_ext), iters=iters,
                      best_th=best_th, best_valid=best_valid)
