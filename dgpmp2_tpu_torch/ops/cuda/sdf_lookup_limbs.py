"""Wrapper of the K-LOOKUP-LIMB CUDA kernel (``csrc/sdf_lookup_limbs.cu``).

Replaces the TPU kernel ``dgpmp2_tpu/ops/pallas/sdf_lookup.py``
``_make_kernel_v3`` with ``_limb_split``: the lookup of an SDF stored as
1–3 bf16 limbs, the ``pallas_v3*`` engines of
:func:`dgpmp2_tpu_torch.ops.sdf.set_lookup_method`.  The kernel reads the
limbs packed by :func:`dgpmp2_tpu_torch.ops.sdf.limb_pack`; its plain
version is :func:`dgpmp2_tpu_torch.ops.sdf.bilinear_lookup_packed`, bit for
bit :func:`~dgpmp2_tpu_torch.ops.sdf.bilinear_lookup_limbs`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.  ``splits`` counts the SDFs split into
the packed layout; it goes up by one in :func:`split` and nowhere else
(``ops.sdf.LIMB_CACHE`` calls it once per SDF tensor and version).
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _tiles

launches = 0
splits = 0


def split(sdf: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """The packed limbs of an (B, H, W) SDF (plain torch, no gradient)."""
    global splits
    with torch.no_grad():
        packed = sdf_ops.limb_pack(sdf_ops.limb_split(sdf.detach(), n_limbs))
    splits += 1
    return packed


def launch(packed: torch.Tensor, points: torch.Tensor, res: float, x_lims,
           y_lims):
    """One kernel launch: float32 ``(d (B, P), grad (B, P, 2))`` on the
    current stream, intended OOB mode, two views of one buffer.

    packed: the bf16 layout of :func:`split`, 8-byte aligned (a cell is
    one load of up to 8 bytes); points (B, P, 2) float32; contiguous CUDA
    tensors on one device.
    """
    global launches
    if packed.data_ptr() % 8:
        raise ValueError("sdf_lookup_limbs kernel needs 8-byte aligned "
                         "packed limbs")
    out = _tiles.launch("sdf_lookup_limbs", packed, points, res,
                        (tuple(x_lims), tuple(y_lims)), "intended")
    launches += 1
    return out


class _LimbLookup(torch.autograd.Function):
    """Forward is one kernel launch on the packed limbs.  Backward replays
    the exact plain :func:`~dgpmp2_tpu_torch.ops.sdf.bilinear_lookup` on the
    unsplit SDF, as the TPU kernel's ``_mxu_replay_bwd`` does."""

    @staticmethod
    def forward(ctx, sdf, points, packed, res, x_lims, y_lims):
        ctx.save_for_backward(sdf, points)
        ctx.args = (res, x_lims, y_lims)
        return _forward(packed, points, res, x_lims, y_lims)

    @staticmethod
    def backward(ctx, d_bar, g_bar):
        sdf, points = ctx.saved_tensors
        with torch.enable_grad():
            s = sdf.detach().requires_grad_(ctx.needs_input_grad[0])
            p = points.detach().requires_grad_(ctx.needs_input_grad[1])
            d, g = sdf_ops.bilinear_lookup(s, p, *ctx.args, "intended")
            wrt = [t for t in (s, p) if t.requires_grad]
            grads = iter(torch.autograd.grad(
                (d, g), wrt, (d_bar.to(d.dtype), g_bar.to(g.dtype)),
                allow_unused=True))
        s_bar = next(grads) if ctx.needs_input_grad[0] else None
        p_bar = next(grads) if ctx.needs_input_grad[1] else None
        return s_bar, p_bar, None, None, None, None


def _forward(packed, points, res, x_lims, y_lims):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    pts = points.to(torch.float32).contiguous()
    if packed.device.type == "cpu" and pts.device.type == "cpu":
        return sdf_ops.bilinear_lookup_packed(packed, pts, res, x_lims,
                                              y_lims)
    return launch(packed, pts, res, x_lims, y_lims)


def limb_lookup(sdf: torch.Tensor, packed: torch.Tensor,
                points: torch.Tensor, res: float, x_lims, y_lims):
    """Differentiable limb-engine lookup of an (B, H, W) SDF, read from its
    packed limbs ``packed`` (:func:`split`), at (B, P, 2) points: float32
    ``(d, grad)``, K-LOOKUP-LIMB for CUDA tensors.  With no gradient to
    record, the lookup and nothing else."""
    x_lims, y_lims = tuple(x_lims), tuple(y_lims)
    if torch.is_grad_enabled() and (sdf.requires_grad
                                    or points.requires_grad):
        return _LimbLookup.apply(sdf, points, packed, res, x_lims, y_lims)
    return _forward(packed, points, res, x_lims, y_lims)
