"""Wrapper of the K-LOOKUP CUDA kernel (``csrc/sdf_lookup.cu``).

Replaces the TPU kernels ``dgpmp2_tpu/ops/pallas/sdf_lookup.py``
``_make_kernel_v2`` and ``_make_kernel`` (v1), which compute the same
function (engines ``auto``/``pallas_v2`` and ``pallas``).  The plain version
is
:func:`dgpmp2_tpu_torch.ops.sdf.bilinear_lookup`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _tiles

launches = 0


def launch(sdf: torch.Tensor, points: torch.Tensor, res: float, x_lims,
           y_lims, oob_mode: str = "intended"):
    """One kernel launch: ``(d (B, P), grad (B, P, 2))`` on the current stream,
    two views of one buffer.

    sdf (B, H, W) and points (B, P, 2): contiguous CUDA tensors of one dtype,
    float32 or float64.
    """
    global launches
    out = _tiles.launch("sdf_lookup", sdf, points, res,
                        (tuple(x_lims), tuple(y_lims)), oob_mode)
    launches += 1
    return out


class _LookupKernel(torch.autograd.Function):
    """Forward is one kernel launch.  Backward replays the plain
    :func:`~dgpmp2_tpu_torch.ops.sdf.bilinear_lookup` under autograd, as the
    TPU kernel's ``_mxu_replay_bwd`` does."""

    @staticmethod
    def forward(ctx, sdf, points, res, x_lims, y_lims, oob_mode):
        ctx.save_for_backward(sdf, points)
        ctx.args = (res, x_lims, y_lims, oob_mode)
        return launch(sdf, points, res, x_lims, y_lims, oob_mode)

    @staticmethod
    def backward(ctx, d_bar, g_bar):
        sdf, points = ctx.saved_tensors
        res, x_lims, y_lims, oob_mode = ctx.args
        with torch.enable_grad():
            s = sdf.detach().requires_grad_(ctx.needs_input_grad[0])
            p = points.detach().requires_grad_(ctx.needs_input_grad[1])
            d, g = sdf_ops.bilinear_lookup(s, p, res, x_lims, y_lims, oob_mode)
            wrt = [t for t in (s, p) if t.requires_grad]
            grads = iter(torch.autograd.grad((d, g), wrt, (d_bar, g_bar),
                                             allow_unused=True))
        s_bar = next(grads) if ctx.needs_input_grad[0] else None
        p_bar = next(grads) if ctx.needs_input_grad[1] else None
        return s_bar, p_bar, None, None, None, None


def bilinear_lookup_cuda(sdf: torch.Tensor, points: torch.Tensor, res: float,
                         x_lims, y_lims, oob_mode: str = "intended"):
    """Differentiable K-LOOKUP of CUDA tensors (see :func:`launch`); a view
    that is not contiguous is copied.  With no gradient to record, one
    launch and nothing else."""
    sdf, points = sdf.contiguous(), points.contiguous()
    if torch.is_grad_enabled() and (sdf.requires_grad
                                    or points.requires_grad):
        return _LookupKernel.apply(sdf, points, res, tuple(x_lims),
                                   tuple(y_lims), oob_mode)
    return launch(sdf, points, res, x_lims, y_lims, oob_mode)
