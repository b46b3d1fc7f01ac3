"""Convolutional environment encoder.

Port of ``dgpmp2_tpu/models/conv_encoder.py``: five 3×3 convolutions with 16,
16, 16, 32 and 32 features, each followed by LayerNorm over the channels
(ε = 1e-6) and ReLU, with a 2×2 max-pool after the first four; the output is
the last feature map flattened in (H', W', C) order, ``32·(H/16)·(W/16)``
features.  :class:`ConvEncoder3D` is the same stack one dimension up, over
voxel grids.

The public layout is the JAX package's channels-last one: inputs are
(B, *spatial, C) and the flatten order is (*spatial, C), so that a dense
layer after it reads its inputs in the same order in both packages.  The
convolutions run on channels-last views (no copy in or out); they are
``nn.Conv2d``/``nn.Conv3d``, as the JAX package leaves them to XLA.  Each
block's LayerNorm, ReLU and pool are one call of
:func:`dgpmp2_tpu_torch.ops.cuda.encoder_norm.norm_relu_pool`: the library
chain on the CPU, one K-NORM launch on the card.  The ``nn.LayerNorm``
modules hold the scales and offsets (``norms.i.weight``/``bias``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dgpmp2_tpu_torch.ops.cuda.encoder_norm import norm_relu_pool

FEATURES = (16, 16, 16, 32, 32)
POOL_AFTER = (True, True, True, True, False)
LN_EPS = 1e-6  # flax's LayerNorm epsilon


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``he_normal``: a normal truncated at two deviations, scaled so
    that its variance is 2 / fan_in."""
    fan_in = weight[0].numel()
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class ConvEncoder(nn.Module):
    """x (B, H, W, C) -> (B, 32·(H/16)·(W/16)) features."""

    ndim = 2

    def __init__(self, in_channels: int,
                 features: Sequence[int] = FEATURES,
                 pool_after: Sequence[bool] = POOL_AFTER):
        super().__init__()
        conv = nn.Conv2d if self.ndim == 2 else nn.Conv3d
        chans = (in_channels, *features)
        self.convs = nn.ModuleList(
            conv(chans[i], chans[i + 1], 3, padding=1)
            for i in range(len(features)))
        self.norms = nn.ModuleList(nn.LayerNorm(f, eps=LN_EPS)
                                   for f in features)
        self.features = tuple(features)
        self.pool_after = tuple(pool_after)

    def out_dim(self, spatial: Sequence[int]) -> int:
        """Feature count for an input of spatial shape ``spatial``."""
        n = self.features[-1]
        for s in spatial:
            for pool in self.pool_after:
                s = s // 2 if pool else s
            n *= s
        return n

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal kernels and zero biases, as the JAX package's init."""
        for conv in self.convs:
            he_normal_(conv.weight.data, generator)
            nn.init.zeros_(conv.bias)
        for norm in self.norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.convs[0].weight.dtype)
        for conv, norm, down in zip(self.convs, self.norms, self.pool_after):
            x = conv(x.movedim(-1, 1)).movedim(1, -1)
            x = norm_relu_pool(x, norm.weight, norm.bias, down, norm.eps)
        return x.reshape(x.shape[0], -1)


class ConvEncoder3D(ConvEncoder):
    """x (B, D, H, W, C) -> (B, 32·(D/16)·(H/16)·(W/16)) features: 3³
    kernels and 2³ pooling."""

    ndim = 3


def normalize_im(im: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalisation to [-1, 1] over the spatial axes of
    (B, *spatial, C); batch and channel kept."""
    axes = tuple(range(1, im.ndim - 1))
    mx = torch.amax(im, dim=axes, keepdim=True)
    mn = torch.amin(im, dim=axes, keepdim=True)
    return 2.0 * ((im - mn) / (mx - mn + 1e-6) - 0.5)
