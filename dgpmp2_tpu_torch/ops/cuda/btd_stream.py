"""Wrapper of the K-STREAM CUDA kernel (``csrc/btd_stream.cu``), and its
plain version.

K-STREAM is one damped Gauss-Newton step of the stream engine: it forms each
time step's block row of the normal equations from the residual pieces and
the per-plan blocks, and pivots it at once, so no (B, T, D, D) system goes
through memory.  It replaces the TPU path ``dgpmp2_tpu/core/stream.py``
``stream_step`` + ``dgpmp2_tpu/ops/pallas/btd_stream.py``.

The arguments, the same for :func:`launch`, :func:`plain` and :func:`solve`:

* ``diag`` (B|1, T1, D, D): S, the GP/prior diagonal with the GN damping
  folded in; ``off``, ``phiT_q``, ``q_inv`` (B|1, T1-1, D, D): -ΦᵀQ⁻¹, ΦᵀQ⁻¹
  and Q⁻¹; ``ks_inv``, ``kg_inv`` (B|1, D, D).  Any broadcast dimension is
  read with stride 0: blocks that every problem shares stay one copy.
* ``r_gp`` (B, T1-1, D), ``r_s``, ``r_g`` (B, D): the residuals.
* ``families``: the unary factors as :class:`Family` (at most 5).
* ``diag_add`` (B, T1, D, D), ``off_add`` (B, T1-1, D, D), ``rhs_add``
  (B, T1, D): optional addends (GP interpolation, the workspace goal).
* ``delta`` (B,) or None: the LM trust-region damping, diag_ii += δ_b diag_ii
  after every addition (GN folds its ``+δI`` into ``diag``).

The blocks, Λs, addends and δ share one dtype (the working dtype) and the
residuals another, which is that of x: float32 and float32, float64 and
float64, or float64 blocks with float32 residuals (the df32 engine).

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.  :func:`geometry` reports the launch plan:
at D <= 16 the lane-group kernel's (producer warps, ring stages, blocks an
SM resident and needed, registers and spill bytes), past 16 the wide or
block kernel's (:func:`rows_plan`: warps, stages, chunk rows, shared
bytes, blocks an SM).  :func:`set_producers` caps the lane group's
producer warps and :func:`set_rows_plan` restricts the wide and block
kernels' plan, for measuring those choices.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence

import torch

from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.utils import settings

launches = 0
MAX_FAMILIES = 5


@dataclasses.dataclass
class Family:
    """A unary factor family: Jacobian rows ``h`` (B, T1, K, D), residuals
    ``r`` (B, T1, K) and its inverse covariance ``w``, (·, ·, K, K), or with
    ``diagonal`` its diagonal (·, ·, K)."""

    h: torch.Tensor
    r: torch.Tensor
    w: torch.Tensor
    diagonal: bool = False


# -- the plain version ---------------------------------------------------------


def _mv(mat, vec):
    return torch.sum(mat * vec[..., None, :], dim=-1)


def plain_system(diag, off, phiT_q, q_inv, ks_inv, kg_inv, r_gp, r_s, r_g,
                 families: Sequence[Family], diag_add=None, off_add=None,
                 rhs_add=None, delta=None):
    """The damped system (diag (B, T1, D, D), off, rhs) that K-STREAM forms,
    in the working dtype, with the standard assembly's factor math
    (``core/graph.assemble_from_residuals``, ``core/gn.damped_system``)."""
    dt = diag.dtype
    b, t, d = r_gp.shape
    r_gp, r_s, r_g = (a.to(dt) for a in (r_gp, r_s, r_g))
    pad_v = torch.nn.functional.pad
    rhs = (pad_v(_mv(phiT_q, r_gp), (0, 0, 0, 1))
           - pad_v(_mv(q_inv, r_gp), (0, 0, 1, 0)))
    rhs = rhs + pad_v(_mv(ks_inv, r_s)[..., None, :], (0, 0, 0, t))
    rhs = rhs + pad_v(_mv(kg_inv, r_g)[..., None, :], (0, 0, t, 0))
    dg = diag.expand(b, t + 1, d, d)
    for f in families:
        h, r = f.h.to(dt), f.r.to(dt)
        lam_h = f.w[..., None] * h if f.diagonal else f.w @ h
        dg = dg + h.transpose(-1, -2) @ lam_h
        rhs = rhs + torch.sum(lam_h * r[..., None], dim=-2)
    if diag_add is not None:
        dg = dg + diag_add
    if rhs_add is not None:
        rhs = rhs + rhs_add
    o = off.expand(b, t, d, d)
    if off_add is not None:
        o = o + off_add
    if delta is not None:
        eye = torch.eye(d, dtype=dt, device=dg.device)
        dg = dg + delta.reshape(-1, 1, 1, 1) * (eye * dg)
    return dg, o, rhs


def plain(*args, **kw) -> torch.Tensor:
    """The kernel's plain version: :func:`plain_system` solved by
    ``tridiag.btd_solve`` (which reads only the lower triangle of each diag
    block), x in the residuals' dtype."""
    x = tridiag.btd_solve(*plain_system(*args, **kw))
    return x.to(args[6].dtype if len(args) > 6 else kw["r_gp"].dtype)


# -- the kernel ----------------------------------------------------------------


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong * 4)]


class _Family(ctypes.Structure):
    _fields_ = [("h", _View), ("r", _View), ("w", _View), ("k", ctypes.c_int),
                ("diagonal", ctypes.c_int)]


class _RowsPlan(ctypes.Structure):
    """``RowsPlan`` of ``csrc/btd_stream.cuh``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "grid", "formers", "stages", "chunk_rows", "row_buffers",
        "stage_bytes", "rows_off", "ry_off", "lh_off", "hd_off", "chunk_elems",
        "stage_off")]
                + [("lam", ctypes.c_int * MAX_FAMILIES),
                   ("smem", ctypes.c_int),
                   ("scratch_block", ctypes.c_longlong)])


class _Args(ctypes.Structure):
    """``StreamArgs`` of ``csrc/btd_stream.cuh``."""

    _fields_ = ([(n, _View) for n in ("diag", "off", "phit_q", "q_inv", "ks",
                                      "kg", "r_gp", "r_s", "r_g", "diag_add",
                                      "off_add", "rhs_add", "delta")]
                + [("fam", _Family * MAX_FAMILIES)]
                + [(n, ctypes.c_int) for n in ("nfam", "batch", "steps", "d")]
                + [(n, ctypes.c_void_p) for n in ("x", "z", "gain",
                                                  "scratch")]
                + [("plan", _RowsPlan)])


def _view(a: Optional[torch.Tensor], shape, dtype, device, name) -> _View:
    """A strided view of ``a`` broadcast to ``shape`` (empty if None)."""
    v = _View()
    if a is None:
        return v
    if a.device != device or a.dtype != dtype:
        raise ValueError(f"btd_stream kernel: {name} is {a.dtype} on "
                         f"{a.device}, expected {dtype} on {device}")
    try:
        e = a.expand(*shape)
    except RuntimeError as err:
        raise ValueError(f"btd_stream kernel: {name} {tuple(a.shape)} does "
                         f"not broadcast to {tuple(shape)}") from err
    v.p = e.data_ptr() if e.numel() else None
    for i, s in enumerate(e.stride()):
        v.s[i] = s
    return v


KINDS = {(torch.float32, torch.float32): "f32",
         (torch.float64, torch.float64): "f64",
         (torch.float64, torch.float32): "mixed"}
GEOMETRY_KEYS = ("producers", "stages", "threads", "smem_bytes",
                 "resident_blocks_per_sm", "needed_blocks_per_sm", "grid",
                 "registers", "local_bytes", "sms")


def geometry(d: int, batch: int, kind: str, device=None,
             families: Optional[Sequence[FamilyShape]] = None) -> dict:
    """The launch plan at ``d`` and ``batch`` for the instance ``kind``
    (``f32``, ``f64`` or ``mixed``) on ``device`` (the current CUDA device
    by default).  D <= 16: the lane-group kernel's, as
    :data:`GEOMETRY_KEYS`; every block of the grid is resident at once
    where ``resident_blocks_per_sm`` reaches ``needed_blocks_per_sm``.  Past
    16: the wide or block kernel's for the ``families`` (their
    :class:`FamilyShape`), as :data:`ROWS_GEOMETRY_KEYS`; its grid is
    persistent, so every block is resident."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    index = torch.cuda.current_device() if device is None else \
        torch.device("cuda", device).index if isinstance(device, int) else \
        torch.device(device).index
    if d > NARROW_MAX:
        if families is None:
            raise ValueError("btd_stream geometry past D = 16 needs the "
                             "families' shapes")
        plan = _plan(d, batch, kind, tuple(families), index)
        regs, local = _rows_attrs(kind, d > WIDE_MAX, index)[:2]
        out = dict(plan, registers=regs, local_bytes=local)
        return {k: out[k] for k in ROWS_GEOMETRY_KEYS}
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(index):
        rc = getattr(_build.library(), f"dgpmp2_btd_stream_{kind}_geometry")(
            d, batch, out)
    _build.check(rc, "btd_stream geometry query")
    return dict(zip(GEOMETRY_KEYS, out))


def set_producers(n: int) -> int:
    """Cap the producer warps of a lane-group block at ``n`` (1-7; 0: no
    cap below the kernel's 7) from the next launch on, for timing that
    choice; returns the previous cap."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    prev = int(_build.library().dgpmp2_btd_stream_set_producers(n))
    settings.changed()
    return prev


# -- the wide and block kernels' launch plan (D > 16) -----------------------

NARROW_MAX = 16      # kNarrowMax: the lane-group kernel's largest D
WIDE_MAX = 32        # kMaxD: the wide kernel's largest D
WIDE_FORMERS = 2     # kWideFormers
BLOCK_FORMERS = 5    # kBlockFormers
BLOCK_CONSUMERS = 4  # kBlockConsumers
# Buffers of a step's rows (a third measured no faster on the 9- and
# 17-link arms and cost the 9-link arm blocks an SM).
ROW_BUFFERS = 2
# The choices the plan tries, in order of preference at equal residency.
STAGES = (3, 2, 4)
CHUNK_ROWS = (32, 64, 16)
ROWS_GEOMETRY_KEYS = ("kernel", "warps", "formers", "consumers", "stages",
                      "chunk_rows", "kept", "stage_bytes",
                      "smem_bytes", "scratch_block", "grid",
                      "resident_blocks_per_sm", "needed_blocks_per_sm",
                      "problems_per_block", "registers", "local_bytes", "sms")


@dataclasses.dataclass(frozen=True)
class FamilyShape:
    """What the plan needs of a family: K, a diagonal Λ, and whether every
    problem and step shares its Λ (so that a block may keep it)."""

    k: int
    diagonal: bool
    shared: bool


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def rows_chunks(fams: Sequence[FamilyShape], chunk_rows: int):
    """(family, first row, rows) of each stage that one step takes, in the
    kernels' order (``chunk_step``): a family with a full Λ whole, a
    diagonal one ``chunk_rows`` rows at a time, an empty family one stage
    of no rows."""
    out = []
    for n, f in enumerate(fams):
        step = chunk_rows if f.diagonal else max(f.k, 1)
        k0 = 0
        while k0 == 0 or k0 < f.k:
            out.append((n, k0, min(step, f.k - k0)))
            k0 += step
    return out


def _stage_need(d, rows, f, kept, ta, tr):
    """Bytes of a stage holding ``rows`` rows of family ``f``: H (with 16
    bytes to match its source's alignment), r and, unless ``kept``, Λ
    (``stage_r_off``, ``stage_w_off``)."""
    w_off = _a16(rows * d * tr + 16) + _a16(rows * tr)
    return w_off + (0 if kept else
                    _a16(rows * (1 if f.diagonal else f.k) * ta))


def rows_layout(d: int, fams: Sequence[FamilyShape], ta: int, tr: int, *,
                formers: int, stages: int, chunk_rows: int, keep: bool,
                optin: int) -> Optional[dict]:
    """The wide or block kernel's dynamic shared memory at ``d`` for the
    families ``fams`` (``ta``, ``tr``: bytes of a block and a residual
    element), as ``RowsPlan``'s fields: the mbarriers, ry, each kept Λ
    (``keep``: every shared Λ), the largest chunk's ΛH and (float32
    residuals) its H and r in float64, the stages, then the rows and
    U_{t-1}, or (the block kernel, D > 32) those in a scratch buffer a
    block where they do not fit ``optin`` bytes.  None where that does not
    fit."""
    kept = [keep and f.shared for f in fams]
    chunks = rows_chunks(fams, chunk_rows)
    stage = max([_stage_need(d, rows, fams[n], kept[n], ta, tr)
                 for n, _, rows in chunks], default=16)
    off = _a16((2 * stages + 2 * ROW_BUFFERS) * 8)

    def region(nbytes):
        nonlocal off
        at = off
        off += _a16(nbytes)
        return at

    lay = dict(formers=formers, stages=stages, chunk_rows=chunk_rows,
               row_buffers=ROW_BUFFERS, stage_bytes=stage)
    lay["ry_off"] = region(d * 8)
    lay["lam"] = [region((f.k if f.diagonal else f.k * f.k) * ta)
                  if kept[n] else -1 for n, f in enumerate(fams)]
    # A chunk's ΛH, and its H and r in float64 where the residuals are
    # float32.
    elems = max([rows * d for _, _, rows in chunks], default=0)
    rows_max = max([rows for _, _, rows in chunks], default=0)
    lay["lh_off"] = region(elems * 8)
    lay["chunk_elems"] = elems
    lay["hd_off"] = region((elems + rows_max) * 8 if tr == 4 else 0)
    lay["stage_off"] = region(stages * stage)
    rows_bytes = (ROW_BUFFERS * d * (2 * d + 1) + d * (d + 1)) * 8
    if off + rows_bytes <= optin:
        lay["rows_off"], lay["scratch_block"] = region(rows_bytes), 0
    elif d <= WIDE_MAX:
        return None  # the wide kernel keeps its rows in shared memory
    else:
        lay["rows_off"], lay["scratch_block"] = -1, _a16(rows_bytes)
    lay["smem"] = off
    lay["kept"] = sum(kept)
    return lay if off <= optin else None


def rows_plan(d: int, batch: int, ta: int, tr: int,
              fams: Sequence[FamilyShape],
              occupancy: Callable[[int, int], int], optin: int, sms: int,
              caps: Optional[dict] = None) -> dict:
    """The launch plan of the wide (D = 17-32) or block (D > 32) kernel:
    ``occupancy(threads, smem)`` gives the blocks an SM.  Of the choices
    (former warps, up to one per 32 tiles of the lower triangle; keeping
    the shared Λs, stages, chunk rows; ``caps`` restricts each), the first
    in the order of preference (more formers, keeping, :data:`STAGES`,
    :data:`CHUNK_ROWS`) with the most blocks an SM, up to those the batch
    needs.  The grid is persistent: those blocks on every SM, each taking a
    problem after another."""
    caps = caps or {}
    block = d > WIDE_MAX
    consumers = BLOCK_CONSUMERS if block else 1
    hp = (d + 1) // 2
    fmax = min(BLOCK_FORMERS if block else WIDE_FORMERS,
               max(1, -(-hp * (hp + 1) // 2 // 32)))
    need = -(-batch // sms)
    best = None
    for formers in range(fmax, 0, -1):
        for keep in (True, False):
            for stages in STAGES:
                for ck in CHUNK_ROWS:
                    choice = dict(formers=formers, keep=keep, stages=stages,
                                  chunk_rows=ck)
                    if any(choice[k] != v for k, v in caps.items()):
                        continue
                    lay = rows_layout(d, fams, ta, tr, formers=formers,
                                      stages=stages, chunk_rows=ck, keep=keep,
                                      optin=optin)
                    if lay is None:
                        continue
                    threads = 32 * (consumers + formers + 1)
                    res = occupancy(threads, lay["smem"])
                    if res >= 1 and (best is None
                                     or min(res, need) > best[0]):
                        best = (min(res, need), res, threads, lay)
    if best is None:
        raise ValueError(f"btd_stream kernel: no launch plan at D={d} for "
                         f"families {list(fams)} (caps {caps}) fits "
                         f"{optin} bytes of shared memory")
    _, res, threads, lay = best
    grid = min(batch, res * sms)
    return dict(lay, kernel="block" if block else "wide", grid=grid,
                warps=threads // 32, consumers=consumers, threads=threads,
                smem_bytes=lay["smem"], resident_blocks_per_sm=res,
                needed_blocks_per_sm=-(-grid // sms),
                problems_per_block=-(-batch // grid), sms=sms)


_ROWS_CAPS: dict = {}


def set_rows_plan(**caps) -> dict:
    """Restrict the wide and block kernels' plan from the next launch on to
    the given ``formers``, ``keep``, ``stages`` and ``chunk_rows`` (none
    given: the plan's own choice), for timing those
    choices; returns the previous restriction."""
    global _ROWS_CAPS
    bad = set(caps) - {"formers", "keep", "stages", "chunk_rows"}
    if bad:
        raise ValueError(f"set_rows_plan: unknown {sorted(bad)}")
    prev, _ROWS_CAPS = _ROWS_CAPS, dict(caps)
    _plan.cache_clear()
    settings.changed()
    return prev


@functools.lru_cache(maxsize=None)
def _rows_attrs(kind: str, block: bool, index: int):
    """(registers, local bytes, most threads, opt-in shared bytes, SMs) of
    the wide or block kernel of ``kind`` on device ``index``."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    out = (ctypes.c_int * 5)()
    with torch.cuda.device(index):
        rc = getattr(_build.library(),
                     f"dgpmp2_btd_stream_{kind}_rows_attrs")(int(block), out)
    _build.check(rc, "btd_stream attribute query")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _occupancy(kind: str, block: bool, index: int, threads: int,
               smem: int) -> int:
    from dgpmp2_tpu_torch.ops.cuda import _build

    _rows_attrs(kind, block, index)
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = getattr(_build.library(),
                     f"dgpmp2_btd_stream_{kind}_rows_occupancy")(
            int(block), threads, smem, ctypes.byref(out))
    _build.check(rc, "btd_stream occupancy query")
    return int(out.value)


_SIZES = {"f32": (4, 4), "f64": (8, 8), "mixed": (8, 4)}


@functools.lru_cache(maxsize=None)
def _plan(d: int, batch: int, kind: str, fams: tuple, index: int) -> dict:
    block = d > WIDE_MAX
    _, _, max_threads, optin, sms = _rows_attrs(kind, block, index)
    return rows_plan(d, batch, *_SIZES[kind], fams,
                     lambda n, smem: _occupancy(kind, block, index, n, smem)
                     if n <= max_threads else 0, optin, sms, _ROWS_CAPS)


def family_shapes(families: Sequence[Family], batch: int,
                  t1: int) -> tuple:
    """The :class:`FamilyShape` of each family of a launch at ``batch``
    problems and ``t1`` states."""
    out = []
    for f in families:
        w = f.w.expand(*((batch, t1, f.h.shape[-2]) if f.diagonal
                         else (batch, t1, f.h.shape[-2], f.h.shape[-2])))
        out.append(FamilyShape(
            f.h.shape[-2], bool(f.diagonal),
            (w.stride(0) == 0 or batch == 1) and (w.stride(1) == 0
                                                   or t1 == 1)))
    return tuple(out)


def launch(diag, off, phiT_q, q_inv, ks_inv, kg_inv, r_gp, r_s, r_g,
           families: Sequence[Family], diag_add=None, off_add=None,
           rhs_add=None, delta=None) -> torch.Tensor:
    """One kernel launch on the current CUDA stream: x (B, T1, D) in the
    residuals' dtype (see the module docstring for the arguments)."""
    global launches
    from dgpmp2_tpu_torch.ops.cuda import _build

    if r_gp.ndim != 3:
        raise ValueError(f"btd_stream kernel takes r_gp (B, T, D); got "
                         f"{tuple(r_gp.shape)}")
    b, t, d = r_gp.shape
    t1 = t + 1
    dev, ta, tr = diag.device, diag.dtype, r_gp.dtype
    if dev.type != "cuda":
        raise ValueError(f"btd_stream kernel needs CUDA tensors; diag is on "
                         f"{dev}")
    if (ta, tr) not in KINDS:
        raise ValueError(f"btd_stream kernel takes float32 or float64 blocks "
                         f"and residuals of that dtype, or float64 blocks "
                         f"with float32 residuals; got {ta} and {tr}")
    if len(families) > MAX_FAMILIES:
        raise ValueError(f"btd_stream kernel takes at most {MAX_FAMILIES} "
                         f"families; got {len(families)}")
    args = _Args()
    for name, a, shape, dtype in (
            ("diag", diag, (b, t1, d, d), ta), ("off", off, (b, t, d, d), ta),
            ("phit_q", phiT_q, (b, t, d, d), ta),
            ("q_inv", q_inv, (b, t, d, d), ta), ("ks", ks_inv, (b, d, d), ta),
            ("kg", kg_inv, (b, d, d), ta), ("r_gp", r_gp, (b, t, d), tr),
            ("r_s", r_s, (b, d), tr), ("r_g", r_g, (b, d), tr),
            ("diag_add", diag_add, (b, t1, d, d), ta),
            ("off_add", off_add, (b, t, d, d), ta),
            ("rhs_add", rhs_add, (b, t1, d), ta),
            ("delta", delta, (b,), ta)):
        setattr(args, name, _view(a, shape, dtype, dev, name))
    for i, f in enumerate(families):
        k = f.h.shape[-2]
        w_shape = (b, t1, k) if f.diagonal else (b, t1, k, k)
        args.fam[i] = _Family(_view(f.h, (b, t1, k, d), tr, dev, "h"),
                              _view(f.r, (b, t1, k), tr, dev, "r"),
                              _view(f.w, w_shape, ta, dev, "w"), k,
                              int(f.diagonal))
    x = torch.empty((b, t1, d), dtype=tr, device=dev)
    z = x if ta == tr else torch.empty((b, t1, d), dtype=ta, device=dev)
    gain = torch.empty((b, max(t, 0), d, d), dtype=ta, device=dev)
    scratch = None
    if d > NARROW_MAX and b > 0:
        plan = _plan(d, b, KINDS[(ta, tr)], family_shapes(families, b, t1),
                     dev.index if dev.index is not None
                     else torch.cuda.current_device())
        p = args.plan
        for name, _ in _RowsPlan._fields_:
            if name != "lam":
                setattr(p, name, plan[name])
        for i, v in enumerate(plan["lam"]):
            p.lam[i] = v
        if plan["scratch_block"]:
            scratch = torch.empty((plan["grid"] * plan["scratch_block"],),
                                  dtype=torch.uint8, device=dev)
    args.nfam, args.batch, args.steps, args.d = len(families), b, t1, d
    args.x, args.z, args.gain = x.data_ptr(), z.data_ptr(), gain.data_ptr()
    args.scratch = None if scratch is None else scratch.data_ptr()
    lib = _build.library()
    fn = getattr(lib, f"dgpmp2_btd_stream_{KINDS[(ta, tr)]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.byref(args), stream)
    _build.check(rc, "btd_stream kernel")
    launches += 1
    return x


# -- the differentiable entry ---------------------------------------------------

_NAMES = ("diag", "off", "phiT_q", "q_inv", "ks_inv", "kg_inv", "r_gp", "r_s",
          "r_g")
_OPTIONAL = ("diag_add", "off_add", "rhs_add", "delta")


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where each tensor of :func:`solve`'s arguments sits in the flat list
    that the autograd function takes (None arguments are left out)."""

    optional: tuple  # names of the optional arguments given
    diagonal: tuple  # each family's flag

    def unflatten(self, flat) -> dict:
        n = len(_NAMES)
        kw = dict(zip(_NAMES, flat[:n]))
        kw.update(zip(self.optional, flat[n:n + len(self.optional)]))
        rest = flat[n + len(self.optional):]
        kw["families"] = [Family(*rest[3 * i:3 * i + 3], diagonal=dg)
                          for i, dg in enumerate(self.diagonal)]
        return kw


class _StreamKernel(torch.autograd.Function):
    """Forward: one K-STREAM launch.  Backward: the implicit adjoint of the
    solve, λ = Λ⁻¹ x̄ by one K-BTD launch on the system re-formed by the
    plain assembly, and the cotangents of every input through
    ``torch.autograd.grad`` of that assembly (``tridiag.solve_adjoint``)."""

    @staticmethod
    def forward(ctx, layout, *flat):
        x = launch(**layout.unflatten(flat))
        ctx.layout = layout
        ctx.save_for_backward(*flat, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        from dgpmp2_tpu_torch.ops.cuda import btd_solve as k_btd

        *flat, x = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n) for a, n in zip(flat, need)]
            diag, off, rhs = plain_system(**ctx.layout.unflatten(inputs))
        dt = diag.dtype
        lam = k_btd.launch(*(k_btd._ready(a.detach())
                             for a in (diag, off, x_bar.to(dt))))
        bars = tridiag.solve_adjoint(lam, x.to(dt))
        wanted = [a for a, n in zip(inputs, need) if n]
        outs = [(o, g) for o, g in zip((diag, off, rhs), bars)
                if o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in outs], wanted,
                                         [g for _, g in outs],
                                         allow_unused=True))
        return (None, *(next(grads) if n else None for n in need))


def solve(diag, off, phiT_q, q_inv, ks_inv, kg_inv, r_gp, r_s, r_g,
          families: Sequence[Family], diag_add=None, off_add=None,
          rhs_add=None, delta=None) -> torch.Tensor:
    """The stream step's solve: CPU tensors through :func:`plain`, CUDA
    tensors through one K-STREAM launch (differentiable; no fallback)."""
    kw = dict(diag_add=diag_add, off_add=off_add, rhs_add=rhs_add,
              delta=delta)
    base = (diag, off, phiT_q, q_inv, ks_inv, kg_inv, r_gp, r_s, r_g)
    if diag.device.type == "cpu":
        return plain(*base, families, **kw)
    given = tuple(k for k, v in kw.items() if v is not None)
    layout = _Layout(given, tuple(f.diagonal for f in families))
    flat: List[torch.Tensor] = [*base, *(kw[k] for k in given)]
    for f in families:
        flat += [f.h, f.r, f.w]
    return _StreamKernel.apply(layout, *flat)
