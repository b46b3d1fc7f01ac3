"""Wrapper of the K-LOOKUP-BWD CUDA kernel (``csrc/sdf_lookup_bwd.cu``), the
backward of K-LOOKUP and K-LOOKUP3D.

No TPU kernel computes it: the JAX package replays an XLA formulation of the
lookup under autodiff (``dgpmp2_tpu/ops/pallas/sdf_lookup.py``
``_mxu_replay_bwd``).  Its plain version is :func:`replay`: autograd through
:func:`dgpmp2_tpu_torch.ops.sdf.bilinear_lookup` /
:func:`~dgpmp2_tpu_torch.ops.sdf.trilinear_lookup`.  The backward of the
limb engines (K-LOOKUP-LIMB) stays a replay of the exact lookup.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _build, _tiles

launches = 0


def launch(sdf: torch.Tensor, points: torch.Tensor, d_bar: torch.Tensor,
           g_bar: torch.Tensor, res: float, lims, oob_mode: str = "intended",
           sdf_grad: bool = True):
    """One kernel launch on the current stream: ``(p_bar (B, P, ndim),
    s_bar or None)``, the cotangents of the points and (with ``sdf_grad``)
    of the SDF given those of the lookup's outputs, ``d_bar`` (B, P) and
    ``g_bar`` (B, P, ndim).

    ``lims`` holds (lo, hi) per world axis, x first: two axes for a
    (B, H, W) SDF, three for a (B, D, H, W) one.  CUDA tensors of one dtype,
    float32 or float64; sdf and points contiguous.
    """
    global launches
    ndim = len(lims)
    name = "sdf_lookup_bwd" if ndim == 2 else "sdf_lookup3d_bwd"
    pl = _tiles.plan(name, sdf.shape, points.shape, sdf.dtype, points.dtype,
                     sdf.device, points.device, res, lims, oob_mode)
    if not (sdf.is_contiguous() and points.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    b, p = points.shape[:2]
    if (tuple(d_bar.shape) != (b, p) or tuple(g_bar.shape) != (b, p, ndim)
            or d_bar.dtype != points.dtype or g_bar.dtype != points.dtype
            or d_bar.device != points.device
            or g_bar.device != points.device):
        raise ValueError(
            f"{name} kernel takes d_bar (B, P) and g_bar (B, P, {ndim}) "
            f"like the points; got {tuple(d_bar.shape)} {d_bar.dtype} and "
            f"{tuple(g_bar.shape)} {g_bar.dtype}")
    d_bar, g_bar = d_bar.contiguous(), g_bar.contiguous()
    p_bar = torch.empty_like(points)
    s_bar = torch.zeros_like(sdf) if sdf_grad else None
    _build.check(pl.fn(pl.addr, sdf.data_ptr(), points.data_ptr(),
                       d_bar.data_ptr(), g_bar.data_ptr(), p_bar.data_ptr(),
                       None if s_bar is None else s_bar.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(pl.device.index)),
                 f"{name} kernel")
    launches += 1
    return p_bar, s_bar


def replay(sdf: torch.Tensor, points: torch.Tensor, d_bar: torch.Tensor,
           g_bar: torch.Tensor, res: float, lims, oob_mode: str = "intended",
           sdf_grad: bool = True):
    """The plain version of :func:`launch`: autograd through the plain
    lookup, ``(p_bar, s_bar or None)``."""
    plain = (sdf_ops.bilinear_lookup if len(lims) == 2
             else sdf_ops.trilinear_lookup)
    with torch.enable_grad():
        s = sdf.detach().requires_grad_(sdf_grad)
        p = points.detach().requires_grad_(True)
        d, g = plain(s, p, res, *lims, oob_mode)
        wrt = (p, s) if sdf_grad else (p,)
        grads = torch.autograd.grad((d, g), wrt, (d_bar, g_bar),
                                    allow_unused=True)
    p_bar = grads[0] if grads[0] is not None else torch.zeros_like(points)
    s_bar = None
    if sdf_grad:
        s_bar = grads[1] if grads[1] is not None else torch.zeros_like(sdf)
    return p_bar, s_bar


class LookupFunction(torch.autograd.Function):
    """A lookup kernel's forward (``forward_launch``, K-LOOKUP or
    K-LOOKUP3D) with K-LOOKUP-BWD as its backward."""

    @staticmethod
    def forward(ctx, sdf, points, forward_launch, res, lims, oob_mode):
        ctx.save_for_backward(sdf, points)
        ctx.args = (res, lims, oob_mode)
        return forward_launch(sdf, points, res, *lims, oob_mode)

    @staticmethod
    def backward(ctx, d_bar, g_bar):
        sdf, points = ctx.saved_tensors
        res, lims, oob_mode = ctx.args
        p_bar, s_bar = launch(sdf, points, d_bar, g_bar, res, lims, oob_mode,
                              sdf_grad=ctx.needs_input_grad[0])
        if not ctx.needs_input_grad[1]:
            p_bar = None
        return s_bar, p_bar, None, None, None, None
