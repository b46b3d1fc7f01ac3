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
:func:`launch` and nowhere else.  :func:`geometry` reports the launch plan
of D <= 16 (producer warps, ring stages, blocks an SM resident and needed,
registers and spill bytes), and :func:`set_producers` caps the producer
warps, for measuring that choice.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import torch

from dgpmp2_tpu_torch.ops import tridiag

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


class _Args(ctypes.Structure):
    """``StreamArgs`` of ``csrc/btd_stream.cu``."""

    _fields_ = ([(n, _View) for n in ("diag", "off", "phit_q", "q_inv", "ks",
                                      "kg", "r_gp", "r_s", "r_g", "diag_add",
                                      "off_add", "rhs_add", "delta")]
                + [("fam", _Family * MAX_FAMILIES)]
                + [(n, ctypes.c_int) for n in ("nfam", "batch", "steps", "d")]
                + [(n, ctypes.c_void_p) for n in ("x", "z", "gain",
                                                  "scratch")])


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


@functools.lru_cache(maxsize=None)
def scratch_bytes(d: int, device: torch.device) -> int:
    """Bytes of global scratch per problem the kernel needs at ``d``: 0
    unless D > 32 and its rows exceed the device's opt-in shared memory."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = _build.library().dgpmp2_btd_stream_scratch_bytes(
            d, ctypes.byref(n))
    _build.check(rc, "btd_stream scratch query")
    return int(n.value)


KINDS = {(torch.float32, torch.float32): "f32",
         (torch.float64, torch.float64): "f64",
         (torch.float64, torch.float32): "mixed"}
GEOMETRY_KEYS = ("producers", "stages", "threads", "smem_bytes",
                 "resident_blocks_per_sm", "needed_blocks_per_sm", "grid",
                 "registers", "local_bytes", "sms")


def geometry(d: int, batch: int, kind: str, device=None) -> dict:
    """The lane-group kernel's launch plan at ``d`` (1-16) and ``batch`` for
    the instance ``kind`` (``f32``, ``f64`` or ``mixed``) on ``device`` (the
    current CUDA device by default), as :data:`GEOMETRY_KEYS`: every block
    of the grid is resident at once where ``resident_blocks_per_sm`` reaches
    ``needed_blocks_per_sm``."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device):
        rc = getattr(_build.library(), f"dgpmp2_btd_stream_{kind}_geometry")(
            d, batch, out)
    _build.check(rc, "btd_stream geometry query")
    return dict(zip(GEOMETRY_KEYS, out))


def set_producers(n: int) -> int:
    """Cap the producer warps of a lane-group block at ``n`` (1-7; 0: no
    cap below the kernel's 7) from the next launch on, for timing that
    choice; returns the previous cap."""
    from dgpmp2_tpu_torch.ops.cuda import _build

    return int(_build.library().dgpmp2_btd_stream_set_producers(n))


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
    n = scratch_bytes(d, dev)
    scratch = torch.empty((b * n,), dtype=torch.uint8, device=dev) if n else None
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
