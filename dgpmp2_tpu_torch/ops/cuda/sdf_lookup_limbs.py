"""Wrapper of the K-LOOKUP-LIMB CUDA kernel (``csrc/sdf_lookup_limbs.cu``).

Replaces the TPU kernel ``dgpmp2_tpu/ops/pallas/sdf_lookup.py``
``_make_kernel_v3`` with ``_limb_split``: the lookup of an SDF stored as
1–3 bf16 limbs, the ``pallas_v3*`` engines of
:func:`dgpmp2_tpu_torch.ops.sdf.set_lookup_method`.  The plain version is
:func:`dgpmp2_tpu_torch.ops.sdf.bilinear_lookup_limbs`.

``launches`` counts kernel launches in this process; it goes up by one in
:func:`launch` and nowhere else.
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops.cuda import _build

launches = 0


def launch(limbs: torch.Tensor, points: torch.Tensor, res: float, x_lims,
           y_lims):
    """One kernel launch: float32 ``(d (B, P), grad (B, P, 2))`` on the
    current stream, intended OOB mode.

    limbs (B, L, H, W) bfloat16 with L in 1..3 (:func:`sdf_ops.limb_split`)
    and points (B, P, 2) float32: contiguous CUDA tensors on one device.
    """
    global launches
    _check(limbs, points)
    b, n_limbs, h, w = limbs.shape
    p = points.shape[1]
    lib = _build.library()
    d = torch.empty((b, p), dtype=torch.float32, device=limbs.device)
    grad = torch.empty((b, p, 2), dtype=torch.float32, device=limbs.device)
    with torch.cuda.device(limbs.device):
        stream = torch.cuda.current_stream(limbs.device).cuda_stream
        rc = lib.dgpmp2_sdf_lookup_limbs(
            limbs.data_ptr(), points.data_ptr(), d.data_ptr(),
            grad.data_ptr(), b, p, n_limbs, h, w, res, -x_lims[0] / res,
            -y_lims[0] / res, x_lims[0], x_lims[1], y_lims[0], y_lims[1],
            x_lims[1] - x_lims[0], stream)
    _build.check(rc, "sdf_lookup_limbs kernel")
    launches += 1
    return d, grad


def _check(limbs, points):
    if (limbs.ndim != 4 or not 1 <= limbs.shape[1] <= 3 or points.ndim != 3
            or points.shape[-1] != 2):
        raise ValueError(
            "sdf_lookup_limbs kernel takes limbs (B, L, H, W) with L in 1..3 "
            f"and points (B, P, 2); got {tuple(limbs.shape)} and "
            f"{tuple(points.shape)}"
        )
    if points.shape[0] != limbs.shape[0]:
        raise ValueError(f"batch mismatch: limbs {tuple(limbs.shape)}, points {tuple(points.shape)}")
    for name, a, dtype in (("limbs", limbs, torch.bfloat16),
                           ("points", points, torch.float32)):
        if a.device.type != "cuda" or a.device != limbs.device:
            raise ValueError(f"sdf_lookup_limbs kernel needs CUDA tensors on one device; {name} is on {a.device}")
        if a.dtype != dtype:
            raise ValueError(f"sdf_lookup_limbs kernel needs {name} as {dtype}; got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"sdf_lookup_limbs kernel needs contiguous inputs; {name} is not")


class _LimbLookup(torch.autograd.Function):
    """Forward splits the SDF into limbs once per call and looks them up:
    one kernel launch for CUDA tensors, the plain version for CPU tensors.
    Backward replays the exact plain
    :func:`~dgpmp2_tpu_torch.ops.sdf.bilinear_lookup` on the unsplit SDF,
    as the TPU kernel's ``_mxu_replay_bwd`` does."""

    @staticmethod
    def forward(ctx, sdf, points, res, x_lims, y_lims, n_limbs):
        ctx.save_for_backward(sdf, points)
        ctx.args = (res, x_lims, y_lims)
        limbs = sdf_ops.limb_split(sdf, n_limbs).contiguous()
        pts = points.to(torch.float32).contiguous()
        if limbs.device.type == "cpu" and pts.device.type == "cpu":
            return sdf_ops.bilinear_lookup_limbs(limbs, pts, res, x_lims,
                                                 y_lims)
        return launch(limbs, pts, res, x_lims, y_lims)

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


def limb_lookup(sdf: torch.Tensor, points: torch.Tensor, res: float, x_lims,
                y_lims, n_limbs: int):
    """Differentiable limb-engine lookup of an (B, H, W) SDF with (B, P, 2)
    points: float32 ``(d, grad)``, K-LOOKUP-LIMB for CUDA tensors."""
    return _LimbLookup.apply(sdf, points, res, tuple(x_lims), tuple(y_lims),
                             n_limbs)
