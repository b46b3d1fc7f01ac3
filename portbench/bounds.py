"""The least time the card could take for a piece of work, counted from the
problem's shapes and never from a kernel.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores
and in float64 on its tensor cores.  Each input byte counts as read once
and each output byte as written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
BYTES = {"float32": 4, "float64": 8}


def bound_s(nbytes: float, flops: float, kind: str = "float32") -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of ``kind``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def btd_flops(t: int, d: int) -> float:
    """The fewest operations that solve one block-tridiagonal system of
    ``t`` diagonal blocks of ``d``: per block a Cholesky (d³/3) and the two
    triangular solves (2d²); per coupling the solve W = L⁻¹U (d³), the
    symmetric Schur update (d³) and the products Wᵀz and Wx (4d²)."""
    return t * (d ** 3 / 3 + 2 * d * d) + (t - 1) * (2 * d ** 3 + 4 * d * d)


def btd_bytes(b: int, t: int, d: int, dtype: str = "float32") -> float:
    """K-BTD's traffic: diagonal, coupling and right-hand side read once,
    the solution written once."""
    return BYTES[dtype] * (b * t * d * d + b * (t - 1) * d * d + 2 * b * t * d)


def btd_bound_s(b: int, t: int, d: int, dtype: str = "float32") -> float:
    return bound_s(btd_bytes(b, t, d, dtype), b * btd_flops(t, d), dtype)


# Per state of a 2-D point robot in one GN iteration, beyond the solve: the
# bilinear lookup (4 taps, ~20 operations), the GP factor's two rows of the
# right-hand side (Q⁻¹r and ΦᵀQ⁻¹r, 4d² operations), the obstacle row's
# outer product and right-hand side (2d² + 2d) and the error (2d² + d).
LOOKUP_FLOPS = 20


def gn_iter_flops(t: int, d: int) -> float:
    """Operations of one problem's GN iteration of ``t`` factors (t + 1
    states of ``d``)."""
    per_state = LOOKUP_FLOPS + 4 * d * d + 2 * d * d + 2 * d + 2 * d * d + d
    return btd_flops(t + 1, d) + (t + 1) * per_state


def gn_iter_bytes(b: int, t: int, d: int, dtype: str = "float32") -> float:
    """One GN iteration's least traffic: the trajectory read, the four SDF
    taps of each state's lookup read, the update written, one error per
    problem written."""
    n = BYTES[dtype]
    states = b * (t + 1)
    return n * (states * d + 4 * states + states * d + b)


def gn_iter_bound_s(b: int, t: int, d: int, dtype: str = "float32") -> float:
    return bound_s(gn_iter_bytes(b, t, d, dtype), b * gn_iter_flops(t, d),
                   dtype)

