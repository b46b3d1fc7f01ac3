"""The df32 engine: float32 residuals, the step carried past float32.

Port of ``dgpmp2_tpu/core/df32.py`` (``OptimConfig(engine="df32")``).  The
residuals and Jacobians are evaluated in float32; the normal-equation
assembly and the block-Thomas solve are carried in higher precision, so a
float32 plan takes steps of float64 quality (``docs/F32_PRECISION.md`` §1b:
the float32 step's error comes from forming and solving the normal equations
in one float32 word, not from evaluating the residuals).

The JAX engine carries them in two-float arithmetic (``ops/twofloat.py``,
~2⁻⁴⁹), the TPU's stand-in for float64, which it lacks.  The H100 has native
float64, which carries them at 2⁻⁵³, so the port has no two-float module: on
the card the step is one launch of K-STREAM's mixed instance (float32 loads
and stores, float64 blocks, assembly and pivots); on the CPU, the residual
pieces upcast to float64, the standard assembly, ``gn.damped_system`` and the
plain ``tridiag.btd_solve``, cast down.  Either is the drift table's "f32r
floor" (float32 residuals, float64 downstream).

Scope, as the JAX engine's: the GP prior, the start/goal priors, obstacles
and the unary factors (nonholonomic, velocity and joint limits,
self-collision).  GP interpolation and the workspace goal raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dgpmp2_tpu_torch.core import gn
from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.core import stream
from dgpmp2_tpu_torch.ops import tridiag


def _check(spec: graph_lib.GraphSpec, res: graph_lib.FactorResiduals):
    if spec.use_gp_inter or spec.use_workspace_goal:
        raise NotImplementedError(
            "df32 assembly covers the core + unary factor set; "
            "gp_inter/workspace_goal factors are standard-engine only")
    if res.r_gp.dtype != torch.float32:
        raise ValueError("engine='df32' is a float32 accuracy mode; use the "
                         f"standard engine for {res.r_gp.dtype} runs")


def _to64(x):
    """A dataclass of tensors (None fields kept) in float64."""
    return type(x)(**{f.name: None if getattr(x, f.name) is None
                      else getattr(x, f.name).to(torch.float64)
                      for f in dataclasses.fields(x)})


def floor_step(spec: graph_lib.GraphSpec, params: graph_lib.GraphParams,
               res: graph_lib.FactorResiduals, delta,
               trust_region: bool = False) -> torch.Tensor:
    """The residuals' step through the float64 standard assembly, damping
    and plain solve, in float64 (on any device): the f32r floor."""
    p64, r64 = _to64(params), _to64(res)
    diag, off, rhs = graph_lib.assemble_from_residuals(spec, p64, r64,
                                                       dtype=torch.float64)
    delta = torch.as_tensor(delta, dtype=torch.float64, device=rhs.device)
    system = gn.damped_system(diag, off, rhs, delta, trust_region)
    return tridiag.btd_solve(*system)


def df32_step_from_residuals(spec: graph_lib.GraphSpec,
                             params: graph_lib.GraphParams,
                             res: graph_lib.FactorResiduals, delta,
                             trust_region: bool = False,
                             ss: Optional[stream.StreamStatic] = None
                             ) -> torch.Tensor:
    """One df32 step from float32 residuals: float32 ``dθ`` (B, T+1, D).

    ``delta``: GN's scalar damping or LM's scalar or (B,) lambda.  On the
    card ``ss`` may hold the plan's float64 blocks
    (``stream.build_stream_static(..., torch.float64, reg)``, with GN's
    ``reg`` equal to ``delta``); without it they are built here.
    """
    _check(spec, res)
    if res.r_gp.device.type == "cpu":
        return floor_step(spec, params, res, delta,
                          trust_region).to(torch.float32)
    if ss is None:
        reg = 0.0 if trust_region else float(delta)
        ss = stream.build_stream_static(spec, params, None, res.r_gp.shape[0],
                                        torch.float64, reg)
    return stream.stream_step(spec, params, ss, res, delta, trust_region)


def df32_gn_step(spec: graph_lib.GraphSpec, robot,
                 params: graph_lib.GraphParams, th: torch.Tensor,
                 sdf: torch.Tensor, delta,
                 trust_region: bool = False) -> torch.Tensor:
    """One df32 GN update, residuals evaluated in float32; the counterpart
    of ``gn.gn_step`` on the core factor set."""
    res = graph_lib.eval_residuals(spec, robot, params,
                                   th.to(torch.float32),
                                   sdf.to(torch.float32))
    return df32_step_from_residuals(spec, params, res, delta, trust_region)
