"""Signed-distance fields: exact EDT construction and bilinear lookup.

Port of the 2-D part of ``dgpmp2_tpu/ops/sdf.py``.

* :func:`edt_sq` / :func:`edt` / :func:`sdf_from_occupancy` — exact Euclidean
  distance transform as two dense min-plus passes in int32, chunked over the
  output axis so that the (..., n, n) intermediate stays under a byte limit.
* :func:`bilinear_lookup` — bilinear SDF value + analytic spatial gradient,
  the plain version of the CUDA kernel K-LOOKUP (``ops/cuda/sdf_lookup.py``).
* :func:`lookup` — the dispatcher: CPU tensors go to :func:`bilinear_lookup`,
  a CUDA (B, H, W) SDF with (B, P, 2) points goes to the kernel, any other
  CUDA input raises.

Images are row-major with row 0 at the top of the world (y is flipped):
``px = -x_lims[0]/res + x/res``, ``py = -y_lims[0]/res - y/res``.  The
returned gradient is the true spatial gradient ``∇d = (∂d/∂x, ∂d/∂y)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Peak bytes of one min-plus intermediate before the EDT evaluates its output
# axis in chunks.  The dense form needs lanes·n² int32: at B = 1024 on the
# 130-px padded grid that is 9 GB.
EDT_CHUNK_BYTES = 1 << 30


def _edt_1d_sq(cost: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """``out[..., i] = min_j cost[..., j] + (i - j)²`` along the last axis."""
    n = cost.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=cost.device)
    lanes = cost.numel() // max(n, 1)
    k = max(1, min(n, chunk_bytes // max(lanes * n * 4, 1)))
    outs = []
    for s in range(0, n, k):
        rows = idx[s:s + k]
        pair = (rows[:, None] - idx[None, :]) ** 2  # (k, n)
        outs.append(torch.amin(cost[..., None, :] + pair, dim=-1))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def edt_sq(mask: torch.Tensor,
           chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """Squared EDT (int32) of a boolean (..., H, W) mask: squared distance to
    the nearest True cell; a mask with no True cell gives ``H² + W² + 1``."""
    h, w = mask.shape[-2], mask.shape[-1]
    cap = h * h + w * w + 1
    cost = torch.where(mask, 0, cap).to(torch.int32)
    cost = _edt_1d_sq(cost.transpose(-1, -2), chunk_bytes).transpose(-1, -2)
    cost = _edt_1d_sq(cost, chunk_bytes)
    return torch.clamp(cost, max=cap)


def edt(mask: torch.Tensor, dtype: torch.dtype = torch.float32,
        chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """Euclidean distance in pixels to the nearest True cell; exact in int32
    up to the final sqrt."""
    return torch.sqrt(edt_sq(mask, chunk_bytes).to(dtype))


def sdf_from_occupancy(image: torch.Tensor, res: float = 1.0,
                       threshold: float = 0.75, padlen: int = 1,
                       dtype: torch.dtype = torch.float32,
                       chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """SDF of a grayscale occupancy image (..., H, W), on the image's device.

    ``> threshold`` is free space; a ``padlen``-pixel free border is added,
    then ``(edt(occupied) - edt(free)) * res`` (positive in free space), and
    the border is stripped so the output keeps the input's shape.
    """
    free = image > threshold
    if padlen > 0:
        free = F.pad(free.to(torch.uint8), (padlen,) * 4, value=1).bool()
    out = (edt(~free, dtype, chunk_bytes) - edt(free, dtype, chunk_bytes)) * res
    if padlen > 0:
        out = out[..., padlen:-padlen, padlen:-padlen]
    return out


# Out-of-bounds semantics of the lookup (as ``dgpmp2_tpu.ops.sdf``):
#   "intended"  — d = x_lims[1] - x_lims[0] with zero gradient outside the
#                 world limits, weights from the unclamped fraction (default);
#   "reference" — weights from the clamped corner indices and no masking, so
#                 a point far outside the grid collapses to d = 0.
OOB_MODES = ("intended", "reference")
_OOB_MODE = "intended"


def set_oob_mode(mode: str) -> None:
    """Select the out-of-bounds lookup semantics for this process."""
    global _OOB_MODE
    if mode not in OOB_MODES:
        raise ValueError(mode)
    _OOB_MODE = mode


def bilinear_lookup(sdf: torch.Tensor, points: torch.Tensor, res: float,
                    x_lims, y_lims, oob_mode: str | None = None):
    """Bilinear SDF interpolation with analytic spatial gradient.

    sdf (..., H, W) metric distances, points (..., P, 2) world ``(x, y)``
    with matching leading dims.  Returns d (..., P) and grad (..., P, 2).
    ``oob_mode`` defaults to the process-wide :func:`set_oob_mode` choice.
    Divisions by ``res`` are by a tensor so they round the same on every
    device (PyTorch turns division by a Python scalar into multiplication by
    its reciprocal on CUDA), which keeps the corner choice identical to the
    kernel's.
    """
    h, w = sdf.shape[-2], sdf.shape[-1]
    dtype = sdf.dtype
    x = points[..., 0].to(dtype)
    y = points[..., 1].to(dtype)
    res_t = torch.tensor(res, dtype=dtype, device=sdf.device)
    px = (-x_lims[0] / res) + x / res_t
    py = (-y_lims[0] / res) - y / res_t
    px1f = torch.floor(px)
    py1f = torch.floor(py)
    fx = px - px1f
    fy = py - py1f
    px1 = px1f.long()
    py1 = py1f.long()
    px1c = px1.clamp(0, w - 1)
    px2c = (px1 + 1).clamp(0, w - 1)
    py1c = py1.clamp(0, h - 1)
    py2c = (py1 + 1).clamp(0, h - 1)

    flat = sdf.reshape(*sdf.shape[:-2], h * w)

    def take(pyi, pxi):
        return torch.gather(flat, -1, pyi * w + pxi)

    d11 = take(py1c, px1c)
    d21 = take(py1c, px2c)
    d12 = take(py2c, px1c)
    d22 = take(py2c, px2c)

    reference = (oob_mode or _OOB_MODE) == "reference"
    if reference:
        ax1, ax2 = px2c.to(dtype) - px, px - px1c.to(dtype)
        ay1, ay2 = py2c.to(dtype) - py, py - py1c.to(dtype)
    else:
        ax1, ax2 = 1.0 - fx, fx
        ay1, ay2 = 1.0 - fy, fy
    d = ay1 * (ax1 * d11 + ax2 * d21) + ay2 * (ax1 * d12 + ax2 * d22)
    dd_dpx = ay1 * (d21 - d11) + ay2 * (d22 - d12)
    dd_dpy = ax1 * (d12 - d11) + ax2 * (d22 - d21)
    gx = dd_dpx / res_t
    gy = -dd_dpy / res_t
    if reference:
        return d, torch.stack([gx, gy], dim=-1)

    inside = ((x >= x_lims[0]) & (x <= x_lims[1])
              & (y >= y_lims[0]) & (y <= y_lims[1]))
    zero = torch.zeros((), dtype=dtype, device=sdf.device)
    d = torch.where(inside, d, torch.full_like(d, x_lims[1] - x_lims[0]))
    grad = torch.stack([torch.where(inside, gx, zero),
                        torch.where(inside, gy, zero)], dim=-1)
    return d, grad


def lookup(sdf: torch.Tensor, points: torch.Tensor, res, x_lims, y_lims):
    """Device-dispatched bilinear lookup (see the module docstring)."""
    # Limits loaded as numpy scalars become Python floats before they touch
    # a tensor, so they never promote a float32 lookup.
    res = float(res)
    x_lims = (float(x_lims[0]), float(x_lims[1]))
    y_lims = (float(y_lims[0]), float(y_lims[1]))
    # The y -> row transform (py = -y_lims[0]/res - y/res) is right only for
    # symmetric y limits; refuse an asymmetric world instead of reading wrong
    # rows.
    if abs(y_lims[0] + y_lims[1]) > 1e-9:
        raise NotImplementedError(
            f"asymmetric y_lims {tuple(y_lims)} are not supported by the "
            "reference y->row transform; recenter the world"
        )
    if sdf.device.type == "cpu" and points.device.type == "cpu":
        return bilinear_lookup(sdf, points, res, x_lims, y_lims)
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as kernel

    return kernel.bilinear_lookup_cuda(sdf, points, res, x_lims, y_lims,
                                       _OOB_MODE)
