"""Batched symmetric block-tridiagonal solve: plain PyTorch and dispatch.

Port of ``dgpmp2_tpu/ops/tridiag.py``.  The Gauss-Newton normal matrix
``Λ = AᵀKA`` of a GPMP2 factor graph is SPD and block-tridiagonal with
``D×D`` blocks; it is solved by block Thomas (block Cholesky) in O(T·D³).

Storage convention (as in the JAX package):
``diag`` (..., T, D, D) blocks ``Λ[i, i]``; ``off`` (..., T-1, D, D) blocks
``Λ[i, i+1]`` (the lower blocks are their transposes); ``rhs`` (..., T, D).

:func:`btd_solve` is the plain version of the CUDA kernel K-BTD
(``ops/cuda/btd_solve.py``); :func:`btd_solve_auto` sends CUDA tensors to the
kernel and CPU tensors here.  The kernel runs the same block elimination in
another form: it keeps ``X_t = C_t⁻¹ U_t = G_tᵀ`` and ``z_t = C_t⁻¹ y_t``
from the forward sweep (each pivot block solved by Gauss-Jordan), so its
back sweep is ``x_{T-1} = z_{T-1}``, ``x_t = z_t − X_t x_{t+1}``.  Both
read only the lower triangle of each ``diag`` block, as the Cholesky here
does.  Both differentiate with the implicit adjoint of
a linear solve: with ``x = Λ⁻¹ r`` and cotangent ``x̄``,
``λ = Λ⁻¹ x̄``, ``r̄ = λ``, ``diag̅_i = -λ_i x_iᵀ`` and
``off̅_i = -(λ_i x_{i+1}ᵀ + x_i λ_{i+1}ᵀ)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BTDFactors(NamedTuple):
    """chol (..., T, D, D): lower Cholesky factors of the Schur pivots
    ``C_i = D_i - U_{i-1}ᵀ C_{i-1}⁻¹ U_{i-1}``; gain (..., T-1, D, D):
    ``G_i = U_iᵀ C_i⁻¹``."""

    chol: torch.Tensor
    gain: torch.Tensor


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; where a block is not positive definite, NaN in
    place of an error, as JAX's Cholesky and K-BTD give (a float32 LM plan
    whose lambda overflows proposes NaN steps, which its test rejects)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(l, float("nan")), l)


def btd_factor(diag: torch.Tensor, off: torch.Tensor) -> BTDFactors:
    """Block-Thomas factorisation (forward elimination of the pivots)."""
    l = _cholesky(diag[..., 0, :, :])
    chols, gains = [l], []
    for i in range(1, diag.shape[-3]):
        u = off[..., i - 1, :, :]
        g = torch.cholesky_solve(u, l).transpose(-1, -2)
        l = _cholesky(diag[..., i, :, :] - g @ u)
        chols.append(l)
        gains.append(g)
    gain = torch.stack(gains, dim=-3) if gains else torch.zeros_like(off)
    return BTDFactors(torch.stack(chols, dim=-3), gain)


def btd_solve_factored(factors: BTDFactors, off: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Substitution sweeps given a factorisation."""
    t = rhs.shape[-2]
    # Forward: y_0 = r_0; y_i = r_i - G_{i-1} y_{i-1}
    ys = [rhs[..., 0, :]]
    for i in range(1, t):
        g = factors.gain[..., i - 1, :, :]
        ys.append(rhs[..., i, :] - (g @ ys[-1][..., None])[..., 0])
    # Backward: x_{T-1} = C⁻¹ y_{T-1}; x_i = C_i⁻¹ (y_i - U_i x_{i+1})
    xs = [None] * t
    xs[-1] = torch.cholesky_solve(ys[-1][..., None],
                                  factors.chol[..., -1, :, :])[..., 0]
    for i in reversed(range(t - 1)):
        v = ys[i] - (off[..., i, :, :] @ xs[i + 1][..., None])[..., 0]
        xs[i] = torch.cholesky_solve(v[..., None],
                                     factors.chol[..., i, :, :])[..., 0]
    return torch.stack(xs, dim=-2)


def solve_adjoint(lam: torch.Tensor, x: torch.Tensor):
    """(diag̅, off̅, r̄) from ``λ = Λ⁻¹ x̄`` and the solution ``x``."""
    diag_bar = -lam[..., :, :, None] * x[..., :, None, :]
    off_bar = -(lam[..., :-1, :, None] * x[..., 1:, None, :]
                + x[..., :-1, :, None] * lam[..., 1:, None, :])
    return diag_bar, off_bar, lam


class _BTDSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, diag, off, rhs):
        factors = btd_factor(diag, off)
        x = btd_solve_factored(factors, off, rhs)
        ctx.save_for_backward(factors.chol, factors.gain, off, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        chol, gain, off, x = ctx.saved_tensors
        lam = btd_solve_factored(BTDFactors(chol, gain), off, x_bar)
        return solve_adjoint(lam, x)


def btd_solve(diag: torch.Tensor, off: torch.Tensor,
              rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``Λ x = rhs`` for symmetric block-tridiagonal ``Λ`` (plain torch).

    diag (..., T, D, D) SPD after damping, off (..., T-1, D, D),
    rhs (..., T, D) -> x (..., T, D).
    """
    return _BTDSolve.apply(diag, off, rhs)


def btd_solve_auto(diag: torch.Tensor, off: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """CPU tensors: :func:`btd_solve`.  CUDA tensors: the K-BTD kernel, which
    raises on any input it does not take (there is no plain fallback)."""
    if diag.device.type == "cpu":
        return btd_solve(diag, off, rhs)
    from dgpmp2_tpu_torch.ops.cuda import btd_solve as kernel

    return kernel.btd_solve_cuda(diag, off, rhs)


def btd_matvec(diag: torch.Tensor, off: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``Λ x`` for the block-tridiagonal storage above."""
    y = torch.einsum("...tij,...tj->...ti", diag, x)
    upper = torch.einsum("...tij,...tj->...ti", off, x[..., 1:, :])
    lower = torch.einsum("...tji,...tj->...ti", off, x[..., :-1, :])
    pad_hi = [0, 0, 0, 1]
    pad_lo = [0, 0, 1, 0]
    return (y + torch.nn.functional.pad(upper, pad_hi)
            + torch.nn.functional.pad(lower, pad_lo))
