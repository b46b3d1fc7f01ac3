"""Launch geometry and launch plans of the SDF lookup kernels K-LOOKUP
(``csrc/sdf_lookup.cu``), K-LOOKUP3D (``csrc/sdf_lookup3d.cu``) and
K-LOOKUP-LIMB (``csrc/sdf_lookup_limbs.cu``), whose shared launch is
``csrc/lookup_tiles.cuh``.

The B·P query points are one flat array cut into tiles of :data:`TILE`
points, one block of :data:`TILE` threads per tile; the ragged last tile
is a bounds check in the kernel.  Everything the kernel is told about the
shapes is worked out here, once per shape (:func:`plan`, cached), so that a
launch costs the host one allocation and one ``ctypes`` call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _build

TILE = 128  # points per tile = threads per block
ALIGN = 16  # bytes: where grad starts in the output buffer
MAX_POINTS = 2 ** 31 - 1  # the problem-index multiply is exact below


class Geometry(NamedTuple):
    n: int  # points, B·P
    tiles: int  # blocks
    tail: int  # points of the ragged last tile (0: none)


def geometry(b: int, p: int) -> Geometry:
    """Tiles of the (B·P) points: one block each."""
    n = b * p
    return Geometry(n, -(-n // TILE), n % TILE)


def divisor_magic(d: int) -> tuple[int, int]:
    """``(mul, shift)`` with ``(j * mul) >> shift == j // d`` for every
    ``0 <= j < 2**31`` (``mul < 2**32``): the kernel's problem index
    ``b = j // P`` without a divide."""
    if not 1 <= d <= MAX_POINTS:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    shift = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return -(-(1 << shift) // d), shift


def out_layout(n: int, ndim: int, itemsize: int) -> tuple[int, int]:
    """``(numel, g_offset)`` of the one output buffer: d (n elements), then
    grad (n·ndim) from the first 16-byte boundary after d, so that the
    elementwise work on grad downstream takes its vectorized path."""
    per = ALIGN // itemsize
    g_offset = -(-n // per) * per
    return g_offset + n * ndim, g_offset


def output_views(out: torch.Tensor, b: int, p: int, ndim: int,
                 g_offset: int):
    """d (B, P) and grad (B, P, ndim): contiguous views of ``out``."""
    return (out.as_strided((b, p), (p, 1)),
            out.as_strided((b, p, ndim), (p * ndim, ndim, 1), g_offset))


class LookupPlan(ctypes.Structure):
    """``LookupPlan`` of ``csrc/lookup_tiles.cuh``, field for field."""
    _fields_ = [
        ("g_offset", ctypes.c_longlong),
        ("res", ctypes.c_double),
        ("orig", ctypes.c_double * 3),
        ("lo", ctypes.c_double * 3),
        ("hi", ctypes.c_double * 3),
        ("max_d", ctypes.c_double),
        ("nz", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("n", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("div_mul", ctypes.c_uint),
        ("div_shift", ctypes.c_int),
        ("reference_mode", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


def plan_struct(sdf_shape, npts: int, itemsize: int, res: float, lims,
                oob_mode: str, device: int) -> LookupPlan:
    """The kernel's :class:`LookupPlan` of a (B, [D,] H, W) SDF and P
    points per problem; ``lims`` holds (lo, hi) per world axis, x first."""
    b, *grid_shape = sdf_shape
    nz, h, w = ([1] + list(grid_shape))[-3:]
    ndim = len(lims)
    geo = geometry(b, npts)
    mul, shift = divisor_magic(max(npts, 1))
    s = LookupPlan(
        g_offset=out_layout(geo.n, ndim, itemsize)[1], res=res,
        max_d=lims[0][1] - lims[0][0], nz=nz, h=h, w=w, n=geo.n,
        tiles=geo.tiles, div_mul=mul, div_shift=shift,
        reference_mode=int(oob_mode == "reference"), device=device)
    for i, (lo, hi) in enumerate(lims):
        s.orig[i] = -lo / res
        s.lo[i], s.hi[i] = lo, hi
    return s


class Plan(NamedTuple):
    fn: object  # the ctypes entry point
    addr: int  # address of ``struct``
    struct: LookupPlan
    numel: int
    g_offset: int
    device: torch.device


def _limb_entry(name, sdf_shape, dtype, pts_dtype):
    """K-LOOKUP-LIMB's ``(entry point, (B, H, W))`` of a packed limb layout
    (``ops.sdf.packed_grid``): bf16 limbs and float32 points only."""
    b, h, w, n_limbs = sdf_ops.packed_grid(sdf_shape)
    if dtype != torch.bfloat16 or pts_dtype != torch.float32:
        raise ValueError(f"{name} kernel needs bfloat16 limbs and float32 "
                         f"points; got {dtype} and {pts_dtype}")
    return f"dgpmp2_{name}_l{n_limbs}", (b, h, w)


@functools.lru_cache(maxsize=256)
def plan(name: str, sdf_shape, pts_shape, dtype, pts_dtype, device,
         pts_device, res, lims, oob_mode) -> Plan:
    """The checked launch plan of one shape (cached): raises
    ``ValueError`` on what the kernel ``name`` does not take.  K-LOOKUP and
    K-LOOKUP3D take an SDF and points of one dtype, float32 or float64;
    K-LOOKUP-LIMB (``name`` "sdf_lookup_limbs") a packed bf16 limb layout,
    float32 points and the intended OOB mode."""
    ndim = len(lims)
    limbs = name == "sdf_lookup_limbs"
    if limbs:
        entry, sdf_shape = _limb_entry(name, sdf_shape, dtype, pts_dtype)
        if oob_mode != "intended":
            raise ValueError(f"{name} kernel takes the intended OOB mode "
                             f"only; got {oob_mode!r}")
    want = "(B, H, W)" if ndim == 2 else "(B, D, H, W)"
    if (len(sdf_shape) != ndim + 1 or len(pts_shape) != 3
            or pts_shape[-1] != ndim):
        raise ValueError(
            f"{name} kernel takes sdf {want} and points (B, P, {ndim}); got "
            f"{tuple(sdf_shape)} and {tuple(pts_shape)}")
    if pts_shape[0] != sdf_shape[0]:
        raise ValueError(f"batch mismatch: sdf {tuple(sdf_shape)}, points "
                         f"{tuple(pts_shape)}")
    for what, dev, dt in (("sdf", device, dtype),
                          ("points", pts_device, pts_dtype)):
        if dev.type != "cuda" or dev != device:
            raise ValueError(f"{name} kernel needs CUDA tensors on one "
                             f"device; {what} is on {dev}")
        if not limbs and (dt not in (torch.float32, torch.float64)
                          or dt != dtype):
            raise ValueError(f"{name} kernel needs float32 or float64 of "
                             f"one dtype; {what} is {dt}")
    if oob_mode not in sdf_ops.OOB_MODES:
        raise ValueError(oob_mode)
    b, p = pts_shape[:2]
    if b * p > MAX_POINTS:
        raise ValueError(f"{name} kernel takes fewer than 2**31 points; got "
                         f"{b * p}")
    itemsize = 4 if pts_dtype == torch.float32 else 8
    struct = plan_struct(sdf_shape, p, itemsize, res, lims, oob_mode,
                         device.index)
    lib = _build.library()
    fn = getattr(lib, entry if limbs else f"dgpmp2_{name}_f{8 * itemsize}")
    numel, g_offset = out_layout(b * p, ndim, itemsize)
    return Plan(fn, ctypes.addressof(struct), struct, numel, g_offset, device)


def launch(name: str, sdf: torch.Tensor, points: torch.Tensor, res, lims,
           oob_mode: str):
    """One launch of the lookup kernel ``name`` on the current stream:
    ``(d (B, P), grad (B, P, ndim))`` in the points' dtype, views of one
    buffer."""
    pl = plan(name, sdf.shape, points.shape, sdf.dtype, points.dtype,
              sdf.device, points.device, res, lims, oob_mode)
    if not (sdf.is_contiguous() and points.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    out = torch.empty(pl.numel, dtype=points.dtype, device=sdf.device)
    _build.check(pl.fn(pl.addr, sdf.data_ptr(), points.data_ptr(),
                       out.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(pl.device.index)),
                 f"{name} kernel")
    b, p, ndim = points.shape
    return output_views(out, b, p, ndim, pl.g_offset)
