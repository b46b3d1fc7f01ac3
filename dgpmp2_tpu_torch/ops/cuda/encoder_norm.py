"""Wrapper of the K-NORM CUDA kernel (``csrc/encoder_norm.cu``): one block
of the learned encoder after its convolution, LayerNorm over each pixel's
channels, ReLU and the 2×2 (2×2×2) max-pool, in one launch.

No TPU kernel computes it: the JAX package leaves flax's LayerNorm, ReLU
and max-pool to XLA.  Its plain version is :func:`plain`, the library
chain ``F.layer_norm`` → ``torch.relu`` → ``max_pool2d``/``max_pool3d``
that the encoder ran before the kernel.

:func:`norm_relu_pool` is the encoder's entry: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel (float32 or float64,
16 or 32 channels, 2-D or 3-D) or raises, with no fallback, and under
autograd its backward is K-NORM's own backward kernel
(:func:`launch_backward`).

``launches`` counts kernel launches in this process, forward and
backward; it goes up by one in :func:`launch` and :func:`launch_backward`
and nowhere else.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dgpmp2_tpu_torch.ops.cuda import _build

launches = 0
CHANNELS = (16, 32)
DTYPES = (torch.float32, torch.float64)
THREADS = 256  # the kernels' block size (csrc/encoder_norm.cu kThreads)
BWD_BLOCKS = 1024  # the backward's most blocks, so that many partial sums


def plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          pool: bool, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (B, *spatial, C), ReLU, and
    with ``pool`` a max-pool of window and stride 2 over the spatial axes;
    (B, *spatial', C)."""
    x = torch.relu(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))
    if pool:
        mp = F.max_pool2d if x.dim() == 4 else F.max_pool3d
        x = mp(x.movedim(-1, 1), 2).movedim(1, -1)
    return x


def _check(x, weight, bias):
    if x.dim() not in (4, 5):
        raise ValueError(f"encoder_norm kernel takes (B, H, W, C) or "
                         f"(B, D, H, W, C); got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in CHANNELS:
        raise ValueError(f"encoder_norm kernel has instances for C in "
                         f"{CHANNELS}; got C={c}")
    if x.dtype not in DTYPES:
        raise ValueError(f"encoder_norm kernel takes float32 or float64; "
                         f"got {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if tuple(p.shape) != (c,) or p.dtype != x.dtype:
            raise ValueError(f"encoder_norm kernel needs a {name} of shape "
                             f"({c},) in {x.dtype}; got {tuple(p.shape)} "
                             f"{p.dtype}")
    if x.device.type != "cuda" or any(p.device != x.device
                                      for p in (weight, bias)):
        raise ValueError("encoder_norm kernel takes CUDA tensors on one "
                         "device")


def _ready(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and 16-byte aligned (a copy of a view that is not)."""
    a = a.contiguous()
    return a.clone() if a.numel() and a.data_ptr() % 16 else a


def _dims(x: torch.Tensor, pool: bool):
    """(batch, depth, height, width) of ``x`` (depth 1 in 2-D) and the
    output's shape."""
    b, *spatial, c = x.shape
    depth, height, width = ([1] + spatial)[-3:]
    out = [s // 2 for s in spatial] if pool else spatial
    if b * math.prod(out) > 0x7fffffff:
        raise ValueError(f"encoder_norm kernel takes at most 2**31 - 1 "
                         f"output pixels; got {b * math.prod(out)}")
    return (b, depth, height, width), (b, *out, c)


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           pool: bool, eps: float) -> torch.Tensor:
    """One kernel launch on the current stream: :func:`plain`'s output."""
    global launches
    _check(x, weight, bias)
    x, weight, bias = _ready(x), _ready(weight), _ready(bias)
    dims, shape = _dims(x, pool)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    fn = (lib.dgpmp2_encoder_norm_f32 if x.dtype == torch.float32
          else lib.dgpmp2_encoder_norm_f64)
    _build.check(fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), *dims, x.shape[-1], x.dim() - 2,
                    int(pool), float(eps),
                    torch._C._cuda_getCurrentRawStream(x.device.index)),
                 "encoder_norm kernel")
    launches += 1
    return out


def launch_backward(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, grad: torch.Tensor, pool: bool,
                    eps: float):
    """One kernel launch: ``(dx, dweight, dbias)``, the cotangents of
    :func:`launch`'s inputs given ``grad``, that of its output."""
    global launches
    _check(x, weight, bias)
    x, weight, bias = _ready(x), _ready(weight), _ready(bias)
    dims, shape = _dims(x, pool)
    if tuple(grad.shape) != shape or grad.dtype != x.dtype \
            or grad.device != x.device:
        raise ValueError(f"encoder_norm backward needs a cotangent of shape "
                         f"{shape} in {x.dtype} on {x.device}; got "
                         f"{tuple(grad.shape)} {grad.dtype} {grad.device}")
    c = x.shape[-1]
    # Odd sizes leave the last row (plane) out of every window: zero there.
    uncovered = pool and any(s % 2 for s in x.shape[1:-1])
    dx = torch.zeros_like(x) if uncovered else torch.empty_like(x)
    if grad.numel() == 0:
        return dx.zero_(), torch.zeros_like(weight), torch.zeros_like(bias)
    grad = _ready(grad)
    lanes = c * x.element_size() // 64  # lanes an output pixel
    blocks = min(BWD_BLOCKS, -(-(grad.numel() // c * lanes) // THREADS))
    partial = torch.empty((blocks, 2, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = (lib.dgpmp2_encoder_norm_bwd_f32 if x.dtype == torch.float32
          else lib.dgpmp2_encoder_norm_bwd_f64)
    _build.check(fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                    grad.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                    blocks, *dims, c, x.dim() - 2, int(pool), float(eps),
                    torch._C._cuda_getCurrentRawStream(x.device.index)),
                 "encoder_norm backward kernel")
    launches += 1
    dw, db = partial.sum(0)
    return dx, dw, db


class _NormReluPool(torch.autograd.Function):
    """K-NORM's forward, with its backward kernel as the backward; the
    backward recomputes from the saved input."""

    @staticmethod
    def forward(ctx, x, weight, bias, pool, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (pool, eps)
        return launch(x, weight, bias, pool, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        dx, dw, db = launch_backward(x, weight, bias, grad, *ctx.args)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None, None)


def norm_relu_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pool: bool, eps: float) -> torch.Tensor:
    """:func:`plain`'s function: on the CPU the plain version, on the card
    K-NORM (see the module docstring)."""
    if x.device.type == "cpu":
        return plain(x, weight, bias, pool, eps)
    return _NormReluPool.apply(x, weight, bias, pool, eps)
