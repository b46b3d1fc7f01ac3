"""Wrapper of the K-LOOKUP3D CUDA kernel (``csrc/sdf_lookup3d.cu``).

Replaces the TPU kernel ``dgpmp2_tpu/ops/pallas/sdf_lookup3d.py``
``_make_kernel``.  The plain version is
:func:`dgpmp2_tpu_torch.ops.sdf.trilinear_lookup`; the backward is the
kernel K-LOOKUP-BWD (``ops/cuda/sdf_lookup_bwd.py``).

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops.cuda import _tiles, sdf_lookup_bwd

launches = 0


def launch(sdf: torch.Tensor, points: torch.Tensor, res: float, x_lims,
           y_lims, z_lims, oob_mode: str = "intended"):
    """One kernel launch: ``(d (B, P), grad (B, P, 3))`` on the current stream,
    two views of one buffer.

    sdf (B, D, H, W) and points (B, P, 3): contiguous CUDA tensors of one
    dtype, float32 or float64.
    """
    global launches
    out = _tiles.launch("sdf_lookup3d", sdf, points, res,
                        (tuple(x_lims), tuple(y_lims), tuple(z_lims)),
                        oob_mode)
    launches += 1
    return out


def trilinear_lookup_cuda(sdf: torch.Tensor, points: torch.Tensor,
                          res: float, x_lims, y_lims, z_lims,
                          oob_mode: str = "intended"):
    """Differentiable K-LOOKUP3D of CUDA tensors (see :func:`launch`), its
    backward K-LOOKUP-BWD; a view that is not contiguous is copied.  With no
    gradient to record, one launch and nothing else."""
    sdf, points = sdf.contiguous(), points.contiguous()
    if torch.is_grad_enabled() and (sdf.requires_grad
                                    or points.requires_grad):
        return sdf_lookup_bwd.LookupFunction.apply(
            sdf, points, launch, res,
            (tuple(x_lims), tuple(y_lims), tuple(z_lims)), oob_mode)
    return launch(sdf, points, res, x_lims, y_lims, z_lims, oob_mode)
