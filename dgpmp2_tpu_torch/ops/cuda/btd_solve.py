"""Wrapper of the K-BTD CUDA kernel (``csrc/btd_solve.cuh``, its float32 and
float64 instances ``btd_solve.cu`` and ``btd_solve_f64.cu``).

Replaces the TPU kernels ``dgpmp2_tpu/ops/pallas/btd_solve.py`` and
``dgpmp2_tpu/ops/pallas/btd_stream.py``.  The plain version is
:func:`dgpmp2_tpu_torch.ops.tridiag.btd_solve`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else, as does one of ``regime_launches`` (the
lane group of D <= 16, the wide kernel of D = 17-32, the block kernel past
32, its global-scratch twin past the shared memory), as the kernel
library's own plan names it (:func:`regime`).  :func:`geometry` reports
that plan with the registers and blocks an SM that the card gives it;
:func:`team` is its rule for the regime, instance and threads.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.ops.cuda import _build

launches = 0
REGIMES = ("lane", "wide", "block", "scratch")
regime_launches = dict.fromkeys(REGIMES, 0)


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
    regime_launches[regime(d, diag.dtype, diag.device)] += 1
    return x


# -- the launch plan ----------------------------------------------------------
#
# The kernel library decides each launch (``make_plan`` in btd_solve.cuh:
# regime, instance, threads, shared bytes, grid); :func:`geometry` reports
# its answer.  :func:`team` is the rule it follows for the regime, the
# instance and the threads, which the CPU tests check and the card's tests
# hold equal to the library's.

NARROW_MAX = 16  # kNarrowMax: the lane group's largest D
WIDE_MAX = 32    # kMaxD: the wide kernel's largest D
WIDE_WIDTHS = (20, 24, 28, 32)  # the wide kernel's register widths
CHUNK = 16       # kChunk: elements of a row a block-kernel thread holds
TILE_ROWS = 3    # kTileRows: rows a block-kernel thread holds
BLOCK_MAX_THREADS = 256  # kBlockMaxThreads
SCRATCH_THREADS = 256  # kBlockX * kBlockY
GEOMETRY_KEYS = ("regime", "instance", "threads", "smem_bytes", "grid",
                 "registers", "local_bytes", "static_smem_bytes",
                 "resident_blocks_per_sm", "needed_blocks_per_sm",
                 "problems_per_block", "sms")


def block_tiles(d: int) -> int:
    """Tiles of :data:`CHUNK` elements a row of the block kernel:
    ceil((2 D + 1) / CHUNK)."""
    return -(-(2 * d + 1) // CHUNK)


def block_elems(d: int) -> int:
    """Doubles of the global-scratch kernel's rows a problem: two steps of D
    rows of 2 D + 1 and U_{t-1} (``block_elems``)."""
    return d * (2 * d + 1) * 2 + d * (d + 1)


def team(d: int, optin: int) -> tuple[str, int, int]:
    """(regime, instance, threads) of K-BTD at ``d`` on a card whose blocks
    may opt in to ``optin`` bytes of shared memory: the lane group
    (instance D, a warp), the wide kernel (instance W, the register width D
    is padded to; a warp a problem), the block kernel (instance
    :data:`CHUNK`; :data:`TILE_ROWS` rows of :func:`block_tiles` tiles a
    thread, rounded to warps) or, where the global-scratch kernel's rows
    (:func:`block_elems`) would not fit ``optin``, that kernel.  Raises
    where the block kernel's team exceeds :data:`BLOCK_MAX_THREADS`."""
    if d < 1:
        raise ValueError(f"btd_solve: D={d}")
    if d <= NARROW_MAX:
        return "lane", d, 32
    if d <= WIDE_MAX:
        return "wide", next(w for w in WIDE_WIDTHS if d <= w), 32
    if block_elems(d) * 8 > optin:
        return "scratch", 0, SCRATCH_THREADS
    threads = -(-(-(-d // TILE_ROWS) * block_tiles(d)) // 32) * 32
    if threads > BLOCK_MAX_THREADS:
        raise ValueError(f"btd_solve: the block kernel at D={d} needs "
                         f"{threads} threads (at most {BLOCK_MAX_THREADS})")
    return "block", CHUNK, threads


@functools.lru_cache(maxsize=None)
def _library_plan(d: int, batch: int, dtype: torch.dtype, index: int) -> dict:
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(index):
        lib = _build.library()
        fn = (lib.dgpmp2_btd_plan_f32 if dtype == torch.float32
              else lib.dgpmp2_btd_plan_f64)
        rc = fn(d, batch, out)
    _build.check(rc, "btd_solve plan query")
    plan = dict(zip(("regime", "instance", "threads", "smem_bytes",
                     "registers", "local_bytes", "resident_blocks_per_sm",
                     "grid", "sms", "static_smem_bytes"), out))
    plan["regime"] = REGIMES[plan["regime"]]
    return plan


def _index(device) -> int:
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    d = torch.device(device)
    return torch.cuda.current_device() if d.index is None else d.index


def regime(d: int, dtype: torch.dtype, device=None) -> str:
    """The kernel the library launches at ``d`` (one of :data:`REGIMES`)."""
    return _library_plan(d, 1, dtype, _index(device))["regime"]


def geometry(d: int, batch: int, dtype: torch.dtype, device=None) -> dict:
    """The kernel library's launch at ``d`` and ``batch`` on ``device`` (the
    current CUDA device by default), as :data:`GEOMETRY_KEYS`: regime,
    instance, threads, dynamic shared bytes and blocks; registers and local
    bytes a thread, static shared bytes; blocks an SM resident and those
    the grid puts on an SM (the wide and block grids are persistent: never
    more), and problems a block (1: the batch in one wave)."""
    g = dict(_library_plan(d, batch, dtype, _index(device)))
    g["needed_blocks_per_sm"] = -(-g["grid"] // g["sms"])
    g["problems_per_block"] = -(-batch // g["grid"])
    return {k: g[k] for k in GEOMETRY_KEYS}


@functools.lru_cache(maxsize=None)
def scratch_bytes(d: int, device: torch.device) -> int:
    """Bytes of global scratch per problem the kernel needs at ``d``: 0
    unless D > 32 and the global-scratch kernel's rows (5 D² + 3 D doubles,
    :func:`block_elems`) exceed the device's opt-in shared memory."""
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
