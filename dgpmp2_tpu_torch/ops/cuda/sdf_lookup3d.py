"""Wrapper of the K-LOOKUP3D CUDA kernel (``csrc/sdf_lookup3d.cu``).

Replaces the TPU kernel ``dgpmp2_tpu/ops/pallas/sdf_lookup3d.py``
``_make_kernel``.  The plain version is
:func:`dgpmp2_tpu_torch.ops.sdf.trilinear_lookup`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _build

launches = 0


def launch(sdf: torch.Tensor, points: torch.Tensor, res: float, x_lims,
           y_lims, z_lims, oob_mode: str = "intended"):
    """One kernel launch: ``(d (B, P), grad (B, P, 3))`` on the current stream.

    sdf (B, D, H, W) and points (B, P, 3): contiguous CUDA tensors of one
    dtype, float32 or float64.
    """
    global launches
    _check(sdf, points)
    if oob_mode not in sdf_ops.OOB_MODES:
        raise ValueError(oob_mode)
    b, nz, h, w = sdf.shape
    p = points.shape[1]
    lib = _build.library()
    fn = (lib.dgpmp2_sdf_lookup3d_f32 if sdf.dtype == torch.float32
          else lib.dgpmp2_sdf_lookup3d_f64)
    d = torch.empty((b, p), dtype=sdf.dtype, device=sdf.device)
    grad = torch.empty((b, p, 3), dtype=sdf.dtype, device=sdf.device)
    with torch.cuda.device(sdf.device):
        stream = torch.cuda.current_stream(sdf.device).cuda_stream
        rc = fn(sdf.data_ptr(), points.data_ptr(), d.data_ptr(),
                grad.data_ptr(), b, p, nz, h, w, res, -x_lims[0] / res,
                -y_lims[0] / res, -z_lims[0] / res, x_lims[0], x_lims[1],
                y_lims[0], y_lims[1], z_lims[0], z_lims[1],
                x_lims[1] - x_lims[0], int(oob_mode == "reference"), stream)
    _build.check(rc, "sdf_lookup3d kernel")
    launches += 1
    return d, grad


def _check(sdf, points):
    if sdf.ndim != 4 or points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(
            "sdf_lookup3d kernel takes sdf (B, D, H, W) and points (B, P, 3); "
            f"got {tuple(sdf.shape)} and {tuple(points.shape)}"
        )
    if points.shape[0] != sdf.shape[0]:
        raise ValueError(f"batch mismatch: sdf {tuple(sdf.shape)}, points {tuple(points.shape)}")
    for name, a in (("sdf", sdf), ("points", points)):
        if a.device.type != "cuda" or a.device != sdf.device:
            raise ValueError(f"sdf_lookup3d kernel needs CUDA tensors on one device; {name} is on {a.device}")
        if a.dtype not in (torch.float32, torch.float64) or a.dtype != sdf.dtype:
            raise ValueError(f"sdf_lookup3d kernel needs float32 or float64 of one dtype; {name} is {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"sdf_lookup3d kernel needs contiguous inputs; {name} is not")


class _Lookup3DKernel(torch.autograd.Function):
    """Forward is one kernel launch.  Backward replays the plain
    :func:`~dgpmp2_tpu_torch.ops.sdf.trilinear_lookup` under autograd, as the
    TPU kernel's ``_replay_bwd`` does."""

    @staticmethod
    def forward(ctx, sdf, points, res, x_lims, y_lims, z_lims, oob_mode):
        ctx.save_for_backward(sdf, points)
        ctx.args = (res, x_lims, y_lims, z_lims, oob_mode)
        return launch(sdf, points, res, x_lims, y_lims, z_lims, oob_mode)

    @staticmethod
    def backward(ctx, d_bar, g_bar):
        sdf, points = ctx.saved_tensors
        with torch.enable_grad():
            s = sdf.detach().requires_grad_(ctx.needs_input_grad[0])
            p = points.detach().requires_grad_(ctx.needs_input_grad[1])
            d, g = sdf_ops.trilinear_lookup(s, p, *ctx.args)
            wrt = [t for t in (s, p) if t.requires_grad]
            grads = iter(torch.autograd.grad((d, g), wrt, (d_bar, g_bar),
                                             allow_unused=True))
        s_bar = next(grads) if ctx.needs_input_grad[0] else None
        p_bar = next(grads) if ctx.needs_input_grad[1] else None
        return s_bar, p_bar, None, None, None, None, None


def trilinear_lookup_cuda(sdf: torch.Tensor, points: torch.Tensor,
                          res: float, x_lims, y_lims, z_lims,
                          oob_mode: str = "intended"):
    """Differentiable K-LOOKUP3D of CUDA tensors (see :func:`launch`)."""
    return _Lookup3DKernel.apply(sdf.contiguous(), points.contiguous(), res,
                                 tuple(x_lims), tuple(y_lims), tuple(z_lims),
                                 oob_mode)
