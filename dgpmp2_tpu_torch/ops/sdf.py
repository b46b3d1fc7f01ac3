"""Signed-distance fields: exact EDT construction and SDF lookups.

Port of ``dgpmp2_tpu/ops/sdf.py``.

* :func:`edt_sq` / :func:`edt` / :func:`sdf_from_occupancy` /
  :func:`sdf_from_occupancy_3d` — exact Euclidean distance transform as one
  dense min-plus pass per spatial axis in int32, chunked over the output
  axis so that the (..., k, n) intermediate stays near a byte limit.
* :func:`costmap_2d` / :func:`safe_sdf` — the hinge costmap of an SDF and
  its unhinged form.
* :func:`bilinear_lookup` — bilinear SDF value + analytic spatial gradient,
  the plain version of the CUDA kernel K-LOOKUP (``ops/cuda/sdf_lookup.py``).
* :func:`limb_split` / :func:`bilinear_lookup_limbs` — the SDF as 1–3 bf16
  limbs and the lookup that sums them per tap; :func:`limb_pack` packs the
  limbs into the layout K-LOOKUP-LIMB reads (``ops/cuda/sdf_lookup_limbs.py``)
  and :func:`bilinear_lookup_packed`, its plain version, reads it;
  :data:`LIMB_CACHE` splits an SDF once per plan.
* :func:`trilinear_lookup` — the 3-D voxel lookup, the plain version of
  K-LOOKUP3D (``ops/cuda/sdf_lookup3d.py``).
* :func:`lookup` / :func:`lookup_nd` — the dispatchers: CPU tensors go to
  the plain versions, CUDA tensors of the kernels' shapes go to the
  kernels, any other CUDA input raises.  :func:`set_lookup_method` and
  :func:`set_lookup3d_method` choose the engine as the JAX package does.

Images are row-major with row 0 at the top of the world (y is flipped):
``px = -x_lims[0]/res + x/res``, ``py = -y_lims[0]/res - y/res``.  Voxel
grids are ``sdf[..., z, row, col]`` with z unflipped:
``pz = -z_lims[0]/res + z/res``.  The returned gradient is the true spatial
gradient ``∇d``.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
import torch.nn.functional as F

from dgpmp2_tpu_torch.utils import settings

# Peak bytes of one min-plus intermediate before the EDT evaluates its output
# axis in chunks.  The dense form needs lanes·n² int32: at B = 1024 on the
# 130-px padded grid that is 9 GB.  A chunk holds at least one output
# column, so a pass whose lanes·n·4 bytes exceed the limit (B = 1024 at 66³
# padded: 1.18 GB) runs one column at a time above it.
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


def edt_sq(mask: torch.Tensor, spatial_ndim: int = 2,
           chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """Squared EDT (int32) of a boolean mask over its last ``spatial_ndim``
    axes (2 for images, 3 for voxel grids; leading axes are batch): squared
    distance to the nearest True cell; a mask with no True cell gives
    ``Σ n² + 1``."""
    dims = mask.shape[-spatial_ndim:]
    cap = sum(n * n for n in dims) + 1
    cost = torch.where(mask, 0, cap).to(torch.int32)
    # One dense min-plus pass per spatial axis, innermost last.
    for ax in range(-spatial_ndim, -1):
        cost = _edt_1d_sq(cost.transpose(-1, ax), chunk_bytes).transpose(-1, ax)
    cost = _edt_1d_sq(cost, chunk_bytes)
    return torch.clamp(cost, max=cap)


def edt(mask: torch.Tensor, dtype: torch.dtype = torch.float32,
        spatial_ndim: int = 2,
        chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """Euclidean distance in pixels to the nearest True cell; exact in int32
    up to the final sqrt."""
    return torch.sqrt(edt_sq(mask, spatial_ndim, chunk_bytes).to(dtype))


def _sdf_from_occupancy_nd(image, res, threshold, padlen, dtype, chunk_bytes,
                           spatial_ndim):
    free = image > threshold
    if padlen > 0:
        free = F.pad(free.to(torch.uint8), (padlen,) * (2 * spatial_ndim),
                     value=1).bool()
    kw = dict(dtype=dtype, spatial_ndim=spatial_ndim, chunk_bytes=chunk_bytes)
    out = (edt(~free, **kw) - edt(free, **kw)) * res
    if padlen > 0:
        out = out[(Ellipsis,) + (slice(padlen, -padlen),) * spatial_ndim]
    return out


def sdf_from_occupancy(image: torch.Tensor, res: float = 1.0,
                       threshold: float = 0.75, padlen: int = 1,
                       dtype: torch.dtype = torch.float32,
                       chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """SDF of a grayscale occupancy image (..., H, W), on the image's device.

    ``> threshold`` is free space; a ``padlen``-pixel free border is added,
    then ``(edt(occupied) - edt(free)) * res`` (positive in free space), and
    the border is stripped so the output keeps the input's shape.
    """
    return _sdf_from_occupancy_nd(image, res, threshold, padlen, dtype,
                                  chunk_bytes, 2)


def sdf_from_occupancy_3d(voxels: torch.Tensor, res: float = 1.0,
                          threshold: float = 0.75, padlen: int = 1,
                          dtype: torch.dtype = torch.float32,
                          chunk_bytes: int = EDT_CHUNK_BYTES) -> torch.Tensor:
    """SDF of a voxel occupancy grid (..., D, H, W): the 2-D pipeline with
    a third min-plus pass."""
    return _sdf_from_occupancy_nd(voxels, res, threshold, padlen, dtype,
                                  chunk_bytes, 3)


def costmap_2d(sdf: torch.Tensor, eps) -> torch.Tensor:
    """Hinge costmap ``max(0, eps - sdf)``: ``eps - sdf`` where
    ``sdf <= eps``, else 0 (the learned planner's ``costmap_predict``
    channel)."""
    return torch.where(sdf <= eps, eps - sdf, torch.zeros_like(sdf))


def safe_sdf(sdf: torch.Tensor, eps) -> torch.Tensor:
    """``eps - sdf`` without the hinge."""
    return eps - sdf


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
    settings.changed()


def _axis(p: torch.Tensor, n: int, reference: bool):
    """Along one axis of an n-cell grid: the corners floor(p) and
    floor(p) + 1 clamped to [0, n-1], and their (low, high) weights — from
    the unclamped fraction, or in the "reference" mode from the clamped
    corners, so that they sum to ``p2c - p1c`` (zero when both corners clamp
    together: the collapse outside the grid)."""
    p1f = torch.floor(p)
    p1 = p1f.long()
    p1c = p1.clamp(0, n - 1)
    p2c = (p1 + 1).clamp(0, n - 1)
    if reference:
        return p1c, p2c, p2c.to(p.dtype) - p, p - p1c.to(p.dtype)
    f = p - p1f
    return p1c, p2c, 1.0 - f, f


def _flat_taps(take, w):
    """``taps`` of :func:`_bilinear` for a grid whose flat cell ``row·W +
    col`` ``take`` reads."""
    def taps(px1c, px2c, py1c, py2c):
        return (take(py1c * w + px1c), take(py1c * w + px2c),
                take(py2c * w + px1c), take(py2c * w + px2c))
    return taps


def _bilinear(taps, points, dtype, h, w, res, x_lims, y_lims, reference):
    """Bilinear value and gradient of an (H, W) grid at (..., P, 2) points,
    in ``dtype``; ``taps(px1c, px2c, py1c, py2c)`` reads the four corners
    (d11, d21, d12, d22) of the clamped corner indices."""
    x = points[..., 0].to(dtype)
    y = points[..., 1].to(dtype)
    res_t = torch.tensor(res, dtype=dtype, device=points.device)
    px = (-x_lims[0] / res) + x / res_t
    py = (-y_lims[0] / res) - y / res_t
    px1c, px2c, ax1, ax2 = _axis(px, w, reference)
    py1c, py2c, ay1, ay2 = _axis(py, h, reference)
    d11, d21, d12, d22 = taps(px1c, px2c, py1c, py2c)
    d = ay1 * (ax1 * d11 + ax2 * d21) + ay2 * (ax1 * d12 + ax2 * d22)
    dd_dpx = ay1 * (d21 - d11) + ay2 * (d22 - d12)
    dd_dpy = ax1 * (d12 - d11) + ax2 * (d22 - d21)
    gx = dd_dpx / res_t
    gy = -dd_dpy / res_t
    if reference:
        return d, torch.stack([gx, gy], dim=-1)

    inside = ((x >= x_lims[0]) & (x <= x_lims[1])
              & (y >= y_lims[0]) & (y <= y_lims[1]))
    zero = torch.zeros((), dtype=dtype, device=points.device)
    d = torch.where(inside, d, torch.full_like(d, x_lims[1] - x_lims[0]))
    grad = torch.stack([torch.where(inside, gx, zero),
                        torch.where(inside, gy, zero)], dim=-1)
    return d, grad


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
    flat = sdf.reshape(*sdf.shape[:-2], h * w)
    return _bilinear(_flat_taps(lambda idx: torch.gather(flat, -1, idx), w),
                     points, sdf.dtype, h, w, res, x_lims, y_lims,
                     (oob_mode or _OOB_MODE) == "reference")


def limb_split(sdf: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(B, H, W) SDF -> (B, L, H, W) bf16 limbs with ``S ≈ Σ_l limb_l``:
    each limb is the round-to-nearest-even bf16 of the float32 residual the
    previous limbs leave (as ``_limb_split`` of the TPU kernel T5)."""
    rem = sdf.to(torch.float32)
    limbs = []
    for l in range(n_limbs):
        limb = rem.to(torch.bfloat16)
        limbs.append(limb)
        if l + 1 < n_limbs:  # no residual after the last limb
            rem = rem - limb.to(torch.float32)
    return torch.stack(limbs, dim=-3)


def _limb_sum(cells, idx, n_limbs):
    """Σ_l float(cells[..., l]) at ``idx``, summed in order l = 0..L-1 in
    float32: one tap of a limb layout, as K-LOOKUP-LIMB sums it."""
    tap = torch.gather(cells[..., 0], -1, idx).to(torch.float32)
    for l in range(1, n_limbs):
        tap = tap + torch.gather(cells[..., l], -1, idx).to(torch.float32)
    return tap


def bilinear_lookup_limbs(limbs: torch.Tensor, points: torch.Tensor,
                          res: float, x_lims, y_lims):
    """Bilinear lookup of an SDF stored as bf16 limbs, intended OOB mode.

    limbs (B, L, H, W) bf16 (:func:`limb_split`), points (B, P, 2).  Each tap
    is ``Σ_l float(limb_l)`` summed in order l = 0..L-1 in float32, then the
    intended-mode blend and coordinate arithmetic of
    :func:`bilinear_lookup`.  Returns float32 d (B, P), grad (B, P, 2).
    """
    b, n_limbs, h, w = limbs.shape
    cells = limbs.reshape(b, n_limbs, h * w).transpose(1, 2)
    return _bilinear(_flat_taps(lambda idx: _limb_sum(cells, idx, n_limbs), w),
                     points, torch.float32, h, w, res, x_lims, y_lims, False)


# The layout K-LOOKUP-LIMB reads, packed from the (B, L, H, W) limbs so that
# one load brings every limb of a tap: (B, H, W, S), each grid cell holding
# its L limbs side by side in S = 1, 2 or 4 slots (L = 3 leaves slot 3 at
# zero and never sums it, so a -0.0 tap keeps its sign).
_LIMBS_OF_SLOTS = {1: 1, 2: 2, 4: 3}


def limb_pack(limbs: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W) bf16 limbs -> the packed (B, H, W, S) layout."""
    b, n_limbs, h, w = limbs.shape
    cells = limbs.new_zeros((b, h, w, 4 if n_limbs == 3 else n_limbs))
    cells[..., :n_limbs] = limbs.permute(0, 2, 3, 1)
    return cells


def packed_grid(shape):
    """``(B, H, W, L)`` of a packed limb layout's shape; raises on any
    other shape."""
    if len(shape) != 4 or shape[-1] not in _LIMBS_OF_SLOTS:
        raise ValueError("a packed limb layout is (B, H, W, S) with S in 1, "
                         f"2, 4; got {tuple(shape)}")
    b, h, w, slots = shape
    return b, h, w, _LIMBS_OF_SLOTS[slots]


def bilinear_lookup_packed(packed: torch.Tensor, points: torch.Tensor,
                           res: float, x_lims, y_lims):
    """:func:`bilinear_lookup_limbs` read from the packed layout
    (:func:`limb_pack`), bit for bit: the plain version of K-LOOKUP-LIMB."""
    b, h, w, n_limbs = packed_grid(packed.shape)
    cells = packed.reshape(b, h * w, -1)
    return _bilinear(_flat_taps(lambda idx: _limb_sum(cells, idx, n_limbs), w),
                     points, torch.float32, h, w, res, x_lims, y_lims, False)


class LimbCache:
    """The packed limb layouts of the SDFs the limb engines looked up last,
    so that a plan splits its SDF once, not once per lookup: the H100 form
    of XLA hoisting ``_limb_split`` out of the GN scan.

    An entry is keyed by the SDF tensor's identity (a weakref) and
    ``n_limbs``, and holds while the tensor's ``_version``, shape, dtype and
    device are those it was split at.  It dies with the tensor (the weakref's
    callback), so the cache never keeps a freed SDF's layout alive.  The
    ``SIZE`` entries used last are kept: multistart looks up the K-tiled
    pool and, beside it, the concatenation it scores."""

    SIZE = 4

    def __init__(self):
        self._entries = collections.OrderedDict()

    def get(self, sdf: torch.Tensor, n_limbs: int, split):
        """The layout of ``sdf``: cached, or ``split(sdf, n_limbs)``."""
        key = (id(sdf), n_limbs)
        stamp = (sdf._version, sdf.shape, sdf.dtype, sdf.device)
        entry = self._entries.get(key)
        if entry is not None and entry[0]() is sdf and entry[1] == stamp:
            self._entries.move_to_end(key)
            return entry[2]
        packed = split(sdf, n_limbs)
        ref = weakref.ref(sdf, functools.partial(self._drop, key))
        self._entries[key] = (ref, stamp, packed)
        self._entries.move_to_end(key)
        while len(self._entries) > self.SIZE:
            self._entries.popitem(last=False)
        return packed

    def _drop(self, key, ref):
        entry = self._entries.get(key)
        if entry is not None and entry[0] is ref:
            del self._entries[key]

    def __len__(self):
        return len(self._entries)

    def clear(self):
        self._entries.clear()


LIMB_CACHE = LimbCache()


def trilinear_lookup(sdf: torch.Tensor, points: torch.Tensor, res: float,
                     x_lims, y_lims, z_lims, oob_mode: str | None = None):
    """Trilinear SDF interpolation with analytic spatial gradient.

    sdf (..., D, H, W) metric distances laid out ``[z, row, col]``, points
    (..., P, 3) world ``(x, y, z)``.  Returns d (..., P) and grad (..., P, 3).
    Both OOB modes as :func:`bilinear_lookup`; refuses asymmetric ``y_lims``.
    The plain version of K-LOOKUP3D; divides by a 0-d ``res`` tensor for the
    same reason as :func:`bilinear_lookup`.
    """
    res = float(res)
    x_lims, y_lims, z_lims = _world_lims(x_lims, y_lims, z_lims)
    nz, h, w = sdf.shape[-3], sdf.shape[-2], sdf.shape[-1]
    dtype = sdf.dtype
    x = points[..., 0].to(dtype)
    y = points[..., 1].to(dtype)
    z = points[..., 2].to(dtype)
    res_t = torch.tensor(res, dtype=dtype, device=sdf.device)
    px = (-x_lims[0] / res) + x / res_t
    py = (-y_lims[0] / res) - y / res_t
    pz = (-z_lims[0] / res) + z / res_t

    reference = (oob_mode or _OOB_MODE) == "reference"
    px1c, px2c, ax1, ax2 = _axis(px, w, reference)
    py1c, py2c, ay1, ay2 = _axis(py, h, reference)
    pz1c, pz2c, az1, az2 = _axis(pz, nz, reference)

    flat = sdf.reshape(*sdf.shape[:-3], nz * h * w)

    def take(pzi, pyi, pxi):
        return torch.gather(flat, -1, (pzi * h + pyi) * w + pxi)

    # d{z}{y}{x}: 1 = low corner, 2 = high corner.
    d111 = take(pz1c, py1c, px1c)
    d112 = take(pz1c, py1c, px2c)
    d121 = take(pz1c, py2c, px1c)
    d122 = take(pz1c, py2c, px2c)
    d211 = take(pz2c, py1c, px1c)
    d212 = take(pz2c, py1c, px2c)
    d221 = take(pz2c, py2c, px1c)
    d222 = take(pz2c, py2c, px2c)

    dy11 = ax1 * d111 + ax2 * d112
    dy12 = ax1 * d121 + ax2 * d122
    dy21 = ax1 * d211 + ax2 * d212
    dy22 = ax1 * d221 + ax2 * d222
    dz1 = ay1 * dy11 + ay2 * dy12
    dz2 = ay1 * dy21 + ay2 * dy22
    d = az1 * dz1 + az2 * dz2
    dd_dpx = (az1 * (ay1 * (d112 - d111) + ay2 * (d122 - d121))
              + az2 * (ay1 * (d212 - d211) + ay2 * (d222 - d221)))
    dd_dpy = az1 * (dy12 - dy11) + az2 * (dy22 - dy21)
    dd_dpz = dz2 - dz1
    gx = dd_dpx / res_t
    gy = -dd_dpy / res_t
    gz = dd_dpz / res_t
    if reference:
        return d, torch.stack([gx, gy, gz], dim=-1)

    inside = ((x >= x_lims[0]) & (x <= x_lims[1])
              & (y >= y_lims[0]) & (y <= y_lims[1])
              & (z >= z_lims[0]) & (z <= z_lims[1]))
    zero = torch.zeros((), dtype=dtype, device=sdf.device)
    d = torch.where(inside, d, torch.full_like(d, x_lims[1] - x_lims[0]))
    grad = torch.stack([torch.where(inside, gx, zero),
                        torch.where(inside, gy, zero),
                        torch.where(inside, gz, zero)], dim=-1)
    return d, grad


# 2-D lookup engines, by the JAX package's names (``ops/sdf.py`` there).
# The exact engines all compute bilinear_lookup; on the card they all
# launch K-LOOKUP, which computes what the TPU kernels T3 (pallas_v2) and T4
# (pallas) compute.  The limb engines (T5) read the SDF as 3, 2 or 1 bf16
# limbs and launch K-LOOKUP-LIMB on the card.
EXACT_ENGINES = ("auto", "gather", "pallas", "pallas_v2")
LIMB_ENGINES = {"pallas_v3": 3, "pallas_v3_2": 2, "pallas_v3_1": 1}
_NOT_PORTED_ENGINES = ("mxu", "rows")
_LOOKUP_METHOD = "auto"


def set_lookup_method(method: str) -> None:
    """Select the 2-D lookup engine for this process: 'auto' | 'gather' |
    'pallas' | 'pallas_v2' (exact) or 'pallas_v3' | 'pallas_v3_2' |
    'pallas_v3_1' (SDF in 3, 2 or 1 bf16 limbs; 'pallas_v3_1' is the
    serving trade, a bf16 SDF at ~0.4 % relative error)."""
    global _LOOKUP_METHOD
    if method in _NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"lookup engine {method!r} is an XLA alternate shaped by TPU "
            "costs and is not ported (ROADMAP.md, 'Not to port')"
        )
    if method not in EXACT_ENGINES and method not in LIMB_ENGINES:
        raise ValueError(method)
    _LOOKUP_METHOD = method
    settings.changed()


def _world_lims(*lims):
    """``(x_lims, y_lims[, z_lims])`` as Python floats (numpy scalars never
    promote a float32 lookup), refusing asymmetric y limits: the y -> row
    transform (py = -y_lims[0]/res - y/res) is right only for a centered
    world."""
    lims = tuple((float(lo), float(hi)) for lo, hi in lims)
    if abs(lims[1][0] + lims[1][1]) > 1e-9:
        raise NotImplementedError(
            f"asymmetric y_lims {lims[1]} are not supported by the "
            "reference y->row transform; recenter the world"
        )
    return lims


def lookup(sdf: torch.Tensor, points: torch.Tensor, res, x_lims, y_lims):
    """Device-dispatched bilinear lookup under the :func:`set_lookup_method`
    engine (see the module docstring).  A limb engine reads the SDF's packed
    limbs from :data:`LIMB_CACHE` (split at the first lookup of this tensor)
    and refuses the "reference" OOB mode: its TPU kernel has the intended
    semantics only."""
    res = float(res)
    x_lims, y_lims = _world_lims(x_lims, y_lims)
    n_limbs = LIMB_ENGINES.get(_LOOKUP_METHOD)
    if n_limbs is not None:
        if _OOB_MODE != "intended":
            raise NotImplementedError(
                f"lookup engine {_LOOKUP_METHOD!r} implements the intended "
                "OOB semantics only; use an exact engine in reference mode"
            )
        from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as kernel

        packed = LIMB_CACHE.get(sdf, n_limbs, kernel.split)
        return kernel.limb_lookup(sdf, packed, points, res, x_lims, y_lims)
    if sdf.device.type == "cpu" and points.device.type == "cpu":
        return bilinear_lookup(sdf, points, res, x_lims, y_lims)
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as kernel

    return kernel.bilinear_lookup_cuda(sdf, points, res, x_lims, y_lims,
                                       _OOB_MODE)


LOOKUP3D_ENGINES = ("auto", "gather", "pallas_tile")
_LOOKUP3D_METHOD = "auto"


def set_lookup3d_method(method: str) -> None:
    """Select the 3-D lookup engine: 'auto' | 'gather' | 'pallas_tile'
    (the JAX package's names).  All of them compute :func:`trilinear_lookup`
    and launch K-LOOKUP3D on the card.  'pallas_tile' keeps its TPU
    kernel's refusal of the "reference" OOB mode; that kernel's VMEM-size
    and ``H % 8`` applicability guard (``_pallas3d_ok``) is a TPU artefact
    and is not carried over."""
    global _LOOKUP3D_METHOD
    if method not in LOOKUP3D_ENGINES:
        raise ValueError(method)
    _LOOKUP3D_METHOD = method
    settings.changed()


def lookup_nd(sdf: torch.Tensor, points: torch.Tensor, res, x_lims, y_lims,
              z_lims=None):
    """Workspace-dimension dispatcher: :func:`lookup` when ``z_lims`` is
    None; otherwise CPU tensors go to :func:`trilinear_lookup` and a CUDA
    (B, D, H, W) SDF with (B, P, 3) points to K-LOOKUP3D (any other CUDA
    input raises)."""
    if z_lims is None:
        return lookup(sdf, points, res, x_lims, y_lims)
    res = float(res)
    x_lims, y_lims, z_lims = _world_lims(x_lims, y_lims, z_lims)
    if _LOOKUP3D_METHOD == "pallas_tile" and _OOB_MODE != "intended":
        raise NotImplementedError(
            "pallas_tile implements the intended OOB semantics only; use "
            "the gather engine for reference-parity experiments"
        )
    if sdf.device.type == "cpu" and points.device.type == "cpu":
        return trilinear_lookup(sdf, points, res, x_lims, y_lims, z_lims)
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as kernel

    return kernel.trilinear_lookup_cuda(sdf, points, res, x_lims, y_lims,
                                        z_lims, _OOB_MODE)
