"""Trajectory-initializer network (forward pass).

Port of ``dgpmp2_tpu/models/init_net.py``: the covariance encoder's CNN
trunk, then Dropout/Dense(512)/LayerNorm/ReLU twice and Dense predicting the
interior ``(num_states - 2)·state_dim`` of an initial-trajectory delta; the
endpoint rows of the delta are zero.  Its trainer is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgpmp2_tpu_torch.models.conv_encoder import LN_EPS, ConvEncoder
from dgpmp2_tpu_torch.models.cov_head import xavier_uniform_


class InitNet(nn.Module):
    """(x (B, H, W, C) env stack, th (B, T+1, D) seed) -> (B, T+1, D) delta
    trajectories with zero endpoint rows.  ``spatial`` is (H, W) of the
    stack, which fixes the first dense layer's width."""

    def __init__(self, in_channels: int, spatial: Sequence[int],
                 num_states: int, state_dim: int, hidden: int = 512,
                 dropout_prob: float = 0.5):
        super().__init__()
        self.encoder = ConvEncoder(in_channels)
        in_dim = self.encoder.out_dim(spatial) + num_states * state_dim
        self.dense = nn.ModuleList([nn.Linear(in_dim, hidden),
                                    nn.Linear(hidden, hidden)])
        self.norms = nn.ModuleList(nn.LayerNorm(hidden, eps=LN_EPS)
                                   for _ in range(2))
        self.out = nn.Linear(hidden, (num_states - 2) * state_dim)
        self.num_states, self.state_dim = num_states, state_dim
        self.dropout_prob = dropout_prob

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoder.reset_parameters(generator)
        for dense, norm in zip(self.dense, self.norms):
            xavier_uniform_(dense, generator)
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        xavier_uniform_(self.out, generator)

    def forward(self, x: torch.Tensor, th: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        feats = self.encoder(x)
        h = torch.cat([feats, th.reshape(th.shape[0], -1).to(feats.dtype)],
                      dim=-1)
        for dense, norm in zip(self.dense, self.norms):
            h = F.dropout(h, self.dropout_prob, training=train)
            h = torch.relu(norm(dense(h)))
        h = F.dropout(h, self.dropout_prob, training=train)
        interior = self.out(h).reshape(-1, self.num_states - 2,
                                       self.state_dim)
        z = interior.new_zeros((interior.shape[0], 1, self.state_dim))
        return torch.cat([z, interior, z], dim=1)
