"""Wrapper of the K-BTD CUDA kernel (``csrc/btd_solve.cu``).

Replaces the TPU kernels ``dgpmp2_tpu/ops/pallas/btd_solve.py`` and
``dgpmp2_tpu/ops/pallas/btd_stream.py``.  The plain version is
:func:`dgpmp2_tpu_torch.ops.tridiag.btd_solve`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.ops.cuda import _build

launches = 0


def launch(diag: torch.Tensor, off: torch.Tensor,
           rhs: torch.Tensor) -> torch.Tensor:
    """One kernel launch: x with ``Λ x = rhs``, on the current CUDA stream.

    diag (B, T, D, D), off (B, T-1, D, D), rhs (B, T, D); contiguous,
    16-byte aligned CUDA tensors of one dtype, float32 or float64; any
    D >= 1.  Past D = 32 the kernel's rows live in shared memory up to the
    card's opt-in limit and beyond it in a global scratch buffer allocated
    here (:func:`scratch_bytes`).
    """
    global launches
    _check(diag, off, rhs)
    b, t, d = rhs.shape
    lib = _build.library()
    fn = (lib.dgpmp2_btd_solve_f32 if diag.dtype == torch.float32
          else lib.dgpmp2_btd_solve_f64)
    x = torch.empty_like(rhs)
    # X_t = C_t⁻¹ U_t of the forward sweep, read back by the back sweep.
    gain = torch.empty((b, t - 1, d, d), dtype=diag.dtype,
                       device=diag.device)
    n = scratch_bytes(d, diag.device)
    scratch = (torch.empty((b * n,), dtype=torch.uint8, device=diag.device)
               if n else None)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream(diag.device).cuda_stream
        rc = fn(diag.data_ptr(), off.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                gain.data_ptr(), None if scratch is None else scratch.data_ptr(),
                b, t, d, stream)
    _build.check(rc, "btd_solve kernel")
    launches += 1
    return x


@functools.lru_cache(maxsize=None)
def scratch_bytes(d: int, device: torch.device) -> int:
    """Bytes of global scratch per problem the kernel needs at ``d``: 0
    unless D > 32 and its rows (5 D² + 3 D doubles) exceed the device's
    opt-in shared memory."""
    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = _build.library().dgpmp2_btd_scratch_bytes(d, ctypes.byref(n))
    _build.check(rc, "btd_solve scratch query")
    return int(n.value)


def _check(diag, off, rhs):
    if rhs.ndim != 3:
        raise ValueError(f"btd_solve kernel takes rhs (B, T, D); got {tuple(rhs.shape)}")
    b, t, d = rhs.shape
    if d < 1:
        raise ValueError(f"btd_solve kernel takes D >= 1; got D={d}")
    if tuple(diag.shape) != (b, t, d, d) or tuple(off.shape) != (b, t - 1, d, d):
        raise ValueError(
            f"btd_solve kernel shape mismatch: diag {tuple(diag.shape)}, "
            f"off {tuple(off.shape)}, rhs {tuple(rhs.shape)}"
        )
    for name, a in (("diag", diag), ("off", off), ("rhs", rhs)):
        if a.device.type != "cuda" or a.device != diag.device:
            raise ValueError(f"btd_solve kernel needs CUDA tensors on one device; {name} is on {a.device}")
        if a.dtype not in (torch.float32, torch.float64) or a.dtype != diag.dtype:
            raise ValueError(f"btd_solve kernel needs float32 or float64 of one dtype; {name} is {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"btd_solve kernel needs contiguous inputs; {name} is not")
        if a.numel() and a.data_ptr() % 16:
            raise ValueError(f"btd_solve kernel needs 16-byte aligned inputs; {name} is not")


def _ready(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and 16-byte aligned (a copy of a view that is not)."""
    a = a.contiguous()
    return a.clone() if a.numel() and a.data_ptr() % 16 else a


class _BTDSolveKernel(torch.autograd.Function):
    """Forward and backward are each one kernel launch; the backward solves
    with the cotangent as right-hand side (as the TPU kernels' VJP does)."""

    @staticmethod
    def forward(ctx, diag, off, rhs):
        x = launch(diag, off, rhs)
        ctx.save_for_backward(diag, off, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        diag, off, x = ctx.saved_tensors
        lam = launch(diag, off, _ready(x_bar))
        return tridiag.solve_adjoint(lam, x)


def btd_solve_cuda(diag: torch.Tensor, off: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """Differentiable K-BTD solve of CUDA tensors (see :func:`launch`)."""
    return _BTDSolveKernel.apply(_ready(diag), _ready(off), _ready(rhs))
