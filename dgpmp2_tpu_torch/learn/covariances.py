"""Decoding network outputs into PSD factor covariances.

Port of ``dgpmp2_tpu/learn/covariances.py``.  The network emits a flat
vector; PSD-ness comes from elementwise or outer-product squaring:

* ``fix_dynamics``  — only obstacle weights are learned; the GP covariance
  stays at the fixed value.
* ``diag_identity`` — one scalar per GP factor: ``Q_c⁻¹ = s²·I``.
* ``diag``          — per-axis scalars: ``Q_c⁻¹ = diag(s²)``.
* ``qc_full``       — rank-1 ``Q_c⁻¹ = s sᵀ`` (dof×dof).
* ``q_full``        — rank-1 full GP inverse covariance ``Q⁻¹ = s sᵀ``
  (state_dim×state_dim), used as given.
* ``learn_eps``     — appends per-state obstacle safety margins ``ε = s²``,
  or ``eps_max·σ(s)`` when ``eps_max`` is set.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dgpmp2_tpu_torch.core.graph import GraphSpec

MODES = ("fix_dynamics", "diag_identity", "diag", "qc_full", "q_full")


class DecodedCovariances(NamedTuple):
    qc_inv: Optional[torch.Tensor]  # (B, T, dof, dof) or None (fix_dynamics)
    q_inv: Optional[torch.Tensor]  # (B, T, D, D) for q_full, else None
    obs_inv: torch.Tensor  # (B, T+1, L, L)
    eps: Optional[torch.Tensor]  # (B, T+1, L) when learn_eps


def out_dim(spec: GraphSpec, mode: str, learn_eps: bool = False) -> int:
    """Length of the flat network output."""
    t, tn, l = spec.num_gp_factors, spec.num_traj_states, spec.nlinks
    gp_terms = {
        "fix_dynamics": 0,
        "diag_identity": t,
        "diag": t * spec.dof,
        "qc_full": t * spec.dof,
        "q_full": t * spec.state_dim,
    }[mode]
    d = gp_terms + tn * l
    if learn_eps:
        d += tn * l
    return d


def decode(out: torch.Tensor, spec: GraphSpec, mode: str,
           learn_eps: bool = False,
           eps_max: Optional[float] = None) -> DecodedCovariances:
    """Decode the flat (B, out_dim) network output into covariances, in the
    output's dtype.  ``eps_max`` (with ``learn_eps``) bounds the margin as
    ``eps_max·σ(s)`` in place of the unbounded ``s²``."""
    if mode not in MODES:
        raise ValueError(
            f"unknown dynamics_mode {mode!r}; expected one of {MODES}")
    b = out.shape[0]
    t, tn, l = spec.num_gp_factors, spec.num_traj_states, spec.nlinks
    dof, d = spec.dof, spec.state_dim
    num_obs = tn * l
    eye = torch.eye(dof, dtype=out.dtype, device=out.device)

    qc_inv = q_inv = None
    if mode == "fix_dynamics":
        gp_terms = 0
    elif mode == "diag_identity":
        gp_terms = t
        s = out[:, :gp_terms].reshape(b, t, 1, 1)
        qc_inv = (s * s) * eye
    elif mode == "diag":
        gp_terms = t * dof
        s = out[:, :gp_terms].reshape(b, t, dof)
        qc_inv = (s * s)[..., None] * eye
    elif mode == "qc_full":
        gp_terms = t * dof
        s = out[:, :gp_terms].reshape(b, t, dof, 1)
        qc_inv = s * s.transpose(-1, -2)
    else:  # q_full
        gp_terms = t * d
        s = out[:, :gp_terms].reshape(b, t, d, 1)
        q_inv = s * s.transpose(-1, -2)

    so = out[:, gp_terms:gp_terms + num_obs].reshape(b, tn, l, 1)
    obs_inv = so * so.transpose(-1, -2)

    eps = None
    if learn_eps:
        se = out[:, gp_terms + num_obs:].reshape(b, tn, l)
        eps = se * se if eps_max is None else eps_max * torch.sigmoid(se)
    return DecodedCovariances(qc_inv=qc_inv, q_inv=q_inv, obs_inv=obs_inv,
                              eps=eps)
