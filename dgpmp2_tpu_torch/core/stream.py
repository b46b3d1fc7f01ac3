"""The stream engine: one Gauss-Newton step assembled inside the solve.

Port of ``dgpmp2_tpu/core/stream.py`` (``OptimConfig(engine="stream")``).
The JAX engine assembles the normal equations natively in the layout of its
streaming Pallas solve, so that no (B, T, D, D) array of the damped system
goes through memory each iteration and every Gauss term is elementwise math
that feeds the solve.  Here that is one hand-written kernel, K-STREAM
(``ops/cuda/btd_stream.py``): it forms each time step's block row from the
residual pieces and the per-plan blocks of :class:`StreamStatic`, then
pivots it at once, as K-BTD's sweeps do.  The TPU's layout helpers (the
(T, D·D, S, 128) streaming, its time and batch padding, the shifted
super-diagonals) have no counterpart: the kernel reads the port's
batch-major tensors as they are.

Functionally equal to ``graph.assemble_from_residuals`` +
``gn.damped_system`` + ``tridiag.btd_solve``.  Differentiable: on the card
through K-STREAM's implicit adjoint, on the CPU through the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.ops.cuda import btd_stream


@dataclasses.dataclass
class StreamStatic:
    """What K-STREAM reads once per plan, in the working dtype.  Each block
    has batch dimension 1 (read with stride 0) where every problem shares
    it, as the YAML planners' do, and B where it is per problem (learned
    covariances); a Λ may be 1 along time too.

    diag (·, T1, D, D) the GP/prior diagonal with the scalar GN damping;
    off (·, T, D, D) = -ΦᵀQ⁻¹; phiT_q = ΦᵀQ⁻¹ and q_inv (·, T, D, D);
    ks_inv, kg_inv (·, D, D); the Λ of each unary family: obs_w (·, ·, L, L),
    dyn_w (·, ·, 1) and self_w (·, ·, P) as diagonals, vel_w and jl_w
    (·, ·, dof, dof).
    """

    diag: torch.Tensor
    off: torch.Tensor
    phiT_q: torch.Tensor
    q_inv: torch.Tensor
    ks_inv: torch.Tensor
    kg_inv: torch.Tensor
    obs_w: torch.Tensor
    dyn_w: Optional[torch.Tensor] = None
    vel_w: Optional[torch.Tensor] = None
    self_w: Optional[torch.Tensor] = None
    jl_w: Optional[torch.Tensor] = None


def _compact(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each broadcast (stride-0) dimension cut to length 1."""
    return x[tuple(slice(0, 1) if s == 0 and n > 1 else slice(None)
                   for s, n in zip(x.stride(), x.shape))]


def _shared(x: torch.Tensor) -> bool:
    """Whether every problem of the batch sees the same block."""
    return x.shape[0] == 1 or x.stride(0) == 0


def build_stream_static(spec: graph_lib.GraphSpec,
                        params: graph_lib.GraphParams,
                        static: Optional[graph_lib.StaticBlocks], b: int,
                        dtype: torch.dtype, reg: float = 0.0) -> StreamStatic:
    """The per-plan blocks in ``dtype``, with the scalar GN damping ``reg``
    folded into the diagonal (pass 0 for LM: its per-problem damping is
    applied in :func:`stream_step`).  ``static`` is
    ``graph.assemble_static(spec, params, ...)``, or None to form it here in
    ``dtype``; where Q⁻¹, K_s⁻¹ and K_g⁻¹ are shared by the batch, its first
    problem's blocks stand for all ``b``."""
    shared = all(_shared(a) for a in (params.q_inv, params.ks_inv,
                                      params.kg_inv))
    one = (lambda a: a[:1]) if shared else (lambda a: a)
    if static is None:
        p = dataclasses.replace(params, q_inv=one(params.q_inv).to(dtype),
                                ks_inv=one(params.ks_inv).to(dtype),
                                kg_inv=one(params.kg_inv).to(dtype))
        static = graph_lib.assemble_static(spec, p, dtype)
    diag = one(static.diag_static).to(dtype)
    if reg:
        diag = diag + reg * torch.eye(spec.state_dim, dtype=dtype,
                                      device=diag.device)
    out = dict(
        diag=diag, off=one(static.off).to(dtype),
        phiT_q=one(static.phiT_q).to(dtype),
        q_inv=one(params.q_inv).to(dtype), ks_inv=one(params.ks_inv).to(dtype),
        kg_inv=one(params.kg_inv).to(dtype),
        obs_w=_compact(params.obs_inv).to(dtype))
    if spec.non_holonomic:
        out["dyn_w"] = _compact(params.dyn_inv).to(dtype)[..., None]
    if spec.use_vel_limits:
        out["vel_w"] = _compact(params.vel_inv).to(dtype)
    if spec.use_joint_limits:
        out["jl_w"] = _compact(params.jl_inv).to(dtype)
    if spec.use_self_collision:
        out["self_w"] = _compact(params.self_inv).to(dtype)
    return StreamStatic(**out)


def families(spec: graph_lib.GraphSpec, ss: StreamStatic,
             res: graph_lib.FactorResiduals) -> List[btd_stream.Family]:
    """The unary factor families of ``spec``, in the standard assembly's
    order: obstacles, nonholonomic, velocity limits, joint limits,
    self-collision."""
    out = [btd_stream.Family(res.h_obs, res.r_obs, ss.obs_w)]
    if spec.non_holonomic:
        out.append(btd_stream.Family(res.h_dyn[..., None, :],
                                     res.r_dyn[..., None], ss.dyn_w, True))
    if spec.use_vel_limits:
        out.append(btd_stream.Family(res.h_vel, res.r_vel, ss.vel_w))
    if spec.use_joint_limits:
        out.append(btd_stream.Family(res.h_jl, res.r_jl, ss.jl_w))
    if spec.use_self_collision:
        out.append(btd_stream.Family(res.h_self, res.r_self, ss.self_w, True))
    return out


def addends(spec: graph_lib.GraphSpec, params: graph_lib.GraphParams,
            res: graph_lib.FactorResiduals, dtype: torch.dtype):
    """(diag_add, off_add, rhs_add) of the factors that the kernel takes as
    addends, formed by the standard assembly's code in ``dtype``: the
    workspace goal at the last state and GP interpolation; None where
    ``spec`` has neither."""
    diag_add = off_add = rhs_add = None
    if not (spec.use_workspace_goal or spec.use_gp_inter):
        return diag_add, off_add, rhs_add
    params = dataclasses.replace(params, obs_inv=params.obs_inv.to(dtype),
                                 wg_inv=None if params.wg_inv is None
                                 else params.wg_inv.to(dtype))
    res = dataclasses.replace(res, **{
        name: getattr(res, name).to(dtype)
        for name in ("r_gp", "h_wg", "r_wg", "h_obsi", "r_obsi")
        if getattr(res, name) is not None})
    t = spec.total_time_step
    if spec.use_workspace_goal:
        d_wg, r_wg = graph_lib.workspace_goal_terms(params, res)
        diag_add = F.pad(d_wg[:, None], (0, 0, 0, 0, t, 0))
        rhs_add = F.pad(r_wg[:, None], (0, 0, t, 0))
    if spec.use_gp_inter:
        d_l, d_p, off_add, r_l, r_p = graph_lib.gp_interp_terms(
            spec, params, res, dtype)
        di = F.pad(d_l, (0, 0, 0, 0, 0, 1)) + F.pad(d_p, (0, 0, 0, 0, 1, 0))
        ri = F.pad(r_l, (0, 0, 0, 1)) + F.pad(r_p, (0, 0, 1, 0))
        diag_add = di if diag_add is None else diag_add + di
        rhs_add = ri if rhs_add is None else rhs_add + ri
    return diag_add, off_add, rhs_add


def kernel_args(spec: graph_lib.GraphSpec, params: graph_lib.GraphParams,
                ss: StreamStatic, res: graph_lib.FactorResiduals, delta=None,
                trust_region: bool = False):
    """(args, kwargs) of K-STREAM (``ops/cuda/btd_stream``'s ``launch``,
    ``plain`` and ``solve``) for one step."""
    dtype = ss.diag.dtype
    lm = None
    if trust_region:
        lm = torch.as_tensor(delta, dtype=dtype, device=ss.diag.device
                             ).reshape(-1).expand(res.r_gp.shape[0])
    diag_add, off_add, rhs_add = addends(spec, params, res, dtype)
    args = (ss.diag, ss.off, ss.phiT_q, ss.q_inv, ss.ks_inv, ss.kg_inv,
            res.r_gp, res.r_s, res.r_g, families(spec, ss, res))
    return args, dict(diag_add=diag_add, off_add=off_add, rhs_add=rhs_add,
                      delta=lm)


def stream_step(spec: graph_lib.GraphSpec, params: graph_lib.GraphParams,
                ss: StreamStatic, res: graph_lib.FactorResiduals, delta=None,
                trust_region: bool = False) -> torch.Tensor:
    """One damped GN update ``dθ`` (B, T+1, D) in the residuals' dtype.

    ``delta`` is read only under ``trust_region`` (LM; a scalar or (B,)):
    the scalar GN ``+δI`` was folded into ``ss.diag``.  On CUDA tensors one
    K-STREAM launch; on CPU tensors its plain version.  With ``ss`` in
    float64 and float32 residuals this is the df32 engine's step.
    """
    args, kw = kernel_args(spec, params, ss, res, delta, trust_region)
    return btd_stream.solve(*args, **kw)


def gn_step_stream(spec: graph_lib.GraphSpec, robot,
                   params: graph_lib.GraphParams, th: torch.Tensor,
                   sdf: torch.Tensor, delta, trust_region: bool = False
                   ) -> torch.Tensor:
    """The stream engine's counterpart of ``gn.gn_step``."""
    res = graph_lib.eval_residuals(spec, robot, params, th, sdf)
    static = graph_lib.assemble_static(spec, params, th.dtype)
    reg = 0.0 if trust_region else float(delta)
    ss = build_stream_static(spec, params, static, th.shape[0], th.dtype, reg)
    return stream_step(spec, params, ss, res, delta, trust_region)
