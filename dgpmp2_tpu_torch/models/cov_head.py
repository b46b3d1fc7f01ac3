"""Covariance-prediction heads.

Port of ``dgpmp2_tpu/models/cov_head.py``: maps (conv features ⊕ flattened
trajectory positions) to the flat covariance vector of length ``out_dim``.

* :class:`FeedForwardHead` — Dropout/Dense(1000)/LayerNorm/ReLU,
  Dropout/Dense(640)/LayerNorm/ReLU, Dropout/Dense(out_dim), Xavier-uniform
  kernels.
* :class:`RecurrentHead` — ``num_hidden`` GRU or LSTM cells, one recurrence
  step per GN iteration, then Dense(out_dim).

The cells are written with flax's parameter set, not ``nn.GRUCell`` /
``nn.LSTMCell``: flax's GRU has biases on the input denses ``ir``, ``iz``,
``in`` and on ``hn`` only, its LSTM on the hidden denses ``hi``, ``hf``,
``hg``, ``ho`` only, and its LSTM carry is ``(c, h)``.  So every parameter
maps one to one onto the JAX model's, and none is learned that it lacks.

``out_bias`` (length ``out_dim``) zeroes the final kernel and sets its bias,
so the forward pass at init emits exactly the bias: the static-covariance
planner (``LearnedDiffGPMP2Planner.static_out_bias``).

Dropout (the feed-forward head's, and :class:`~dgpmp2_tpu_torch.models.
init_net.InitNet`'s) draws its keep-masks from an explicit
``torch.Generator``, never from torch's global generator, or takes masks
drawn beforehand (:func:`dropout_masks`), so that a recomputed forward pass
(``torch.utils.checkpoint``) sees the masks of the first: flax's
``nn.Dropout``, a unit kept with probability 1 − p and scaled by 1/(1 − p).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dgpmp2_tpu_torch.models.conv_encoder import LN_EPS


def xavier_uniform_(linear: nn.Linear, generator: torch.Generator) -> None:
    """Xavier-uniform kernel and zero bias (flax's Dense init here)."""
    nn.init.xavier_uniform_(linear.weight, generator=generator)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


def lecun_normal_(linear: nn.Linear, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` (the cells' input kernels): a normal
    truncated at two deviations with variance 1 / fan_in; zero bias."""
    std = (1.0 / linear.in_features) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


# The dropout source of a forward pass in training: a generator to draw the
# keep-masks from, or the masks themselves (:func:`dropout_masks`).
Dropout = Union[torch.Generator, Tuple[torch.Tensor, ...], None]


def dropout_masks(batch: int, widths: Sequence[int], p: float,
                  generator: torch.Generator, device) -> tuple:
    """Boolean keep-masks (batch, width) for each width, each unit kept with
    probability 1 − p: uniform draws from ``generator`` below 1 − p, as
    flax's ``random.bernoulli``.  Empty for p = 0, where flax's dropout is
    the identity."""
    if p == 0.0:
        return ()
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator or "
                         "precomputed masks (no draw from the global RNG)")
    return tuple(torch.rand((batch, w), generator=generator, device=device)
                 < 1.0 - p for w in widths)


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                  p: float) -> torch.Tensor:
    """flax's ``nn.Dropout``: ``x / (1 − p)`` where kept, else 0 (x itself
    with no mask)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def resolve_masks(rng: Dropout, batch: int, widths: Sequence[int], p: float,
                  device) -> tuple:
    """The keep-masks of one forward pass in training: ``rng`` itself when it
    holds masks, else drawn from it (:func:`dropout_masks`); one None per
    width where p = 0."""
    if p == 0.0:
        return (None,) * len(widths)
    if isinstance(rng, tuple):
        if len(rng) != len(widths):
            raise ValueError(f"{len(rng)} dropout masks for {len(widths)} "
                             "dropout layers")
        return rng
    return dropout_masks(batch, widths, p, rng, device)


class _OutDense(nn.Linear):
    """The final Dense: Xavier-uniform with zero bias, or, with ``out_bias``,
    a zero kernel and that bias."""

    def __init__(self, in_dim: int, out_dim: int,
                 out_bias: Optional[Sequence[float]]):
        super().__init__(in_dim, out_dim)
        if out_bias is not None and len(out_bias) != out_dim:
            raise ValueError(f"out_bias has {len(out_bias)} entries for "
                             f"out_dim={out_dim}")
        self.out_bias = None if out_bias is None else tuple(out_bias)

    def init_(self, generator: torch.Generator) -> None:
        if self.out_bias is None:
            xavier_uniform_(self, generator)
            return
        with torch.no_grad():
            nn.init.zeros_(self.weight)
            self.bias.copy_(torch.tensor(self.out_bias,
                                         dtype=self.bias.dtype))


class FeedForwardHead(nn.Module):
    """(feats (B, F), th_pos_flat (B, P)) -> (B, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden: Tuple[int, ...] = (1000, 640),
                 dropout_prob: float = 0.5,
                 out_bias: Optional[Sequence[float]] = None):
        super().__init__()
        dims = (in_dim, *hidden)
        self.dense = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                   for i in range(len(hidden)))
        self.norms = nn.ModuleList(nn.LayerNorm(h, eps=LN_EPS)
                                   for h in hidden)
        self.out = _OutDense(dims[-1], out_dim, out_bias)
        self.dropout_prob = dropout_prob

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense, norm in zip(self.dense, self.norms):
            xavier_uniform_(dense, generator)
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        self.out.init_(generator)

    @property
    def dropout_widths(self) -> Tuple[int, ...]:
        """The widths its dropout layers mask: the input and each hidden
        layer's output."""
        return (self.dense[0].in_features,
                *(d.out_features for d in self.dense))

    def dropout_masks(self, batch: int, generator: torch.Generator) -> tuple:
        """The keep-masks of one training forward pass of ``batch`` rows,
        drawn from ``generator`` on the head's device."""
        return dropout_masks(batch, self.dropout_widths, self.dropout_prob,
                             generator, self.out.weight.device)

    def forward(self, feats: torch.Tensor, th_pos_flat: torch.Tensor,
                train: bool = False, rng: Dropout = None) -> torch.Tensor:
        """With ``train``, dropout before each dense layer, its masks from
        ``rng`` (a generator, or :meth:`dropout_masks`' masks)."""
        x = torch.cat([feats, th_pos_flat], dim=-1).to(self.out.weight.dtype)
        p = self.dropout_prob
        keep = (resolve_masks(rng, x.shape[0], self.dropout_widths, p,
                              x.device) if train
                else (None,) * (len(self.dense) + 1))
        for dense, norm, k in zip(self.dense, self.norms, keep):
            x = torch.relu(norm(dense(apply_dropout(x, k, p))))
        return self.out(apply_dropout(x, keep[-1], p))


class GRUCell(nn.ModuleDict):
    """Flax's ``GRUCell``: r = σ(ir x + hr h), z = σ(iz x + hz h),
    n = tanh(in x + r ⊙ hn h), h' = (1 - z) n + z h; carry h."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__({
            "ir": nn.Linear(in_dim, hidden_dim),
            "iz": nn.Linear(in_dim, hidden_dim),
            "in": nn.Linear(in_dim, hidden_dim),
            "hr": nn.Linear(hidden_dim, hidden_dim, bias=False),
            "hz": nn.Linear(hidden_dim, hidden_dim, bias=False),
            "hn": nn.Linear(hidden_dim, hidden_dim),
        })

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, dense in self.items():
            if name[0] == "i":
                lecun_normal_(dense, generator)
            else:
                nn.init.orthogonal_(dense.weight, generator=generator)
                if dense.bias is not None:
                    nn.init.zeros_(dense.bias)

    def zero_carry(self, batch: int, like: torch.Tensor) -> torch.Tensor:
        return like.new_zeros((batch, self["hr"].in_features))

    def forward(self, h, x):
        r = torch.sigmoid(self["ir"](x) + self["hr"](h))
        z = torch.sigmoid(self["iz"](x) + self["hz"](h))
        n = torch.tanh(self["in"](x) + r * self["hn"](h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class LSTMCell(nn.ModuleDict):
    """Flax's ``LSTMCell``: i, f, o = σ(i· x + h· h), g = tanh(ig x + hg h),
    c' = f c + i g, h' = o tanh(c'); carry (c, h)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__({
            **{k: nn.Linear(in_dim, hidden_dim, bias=False)
               for k in ("ii", "if", "ig", "io")},
            **{k: nn.Linear(hidden_dim, hidden_dim)
               for k in ("hi", "hf", "hg", "ho")},
        })

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, dense in self.items():
            if name[0] == "i":
                lecun_normal_(dense, generator)
            else:
                nn.init.orthogonal_(dense.weight, generator=generator)
                nn.init.zeros_(dense.bias)

    def zero_carry(self, batch: int, like: torch.Tensor):
        z = like.new_zeros((batch, self["hi"].in_features))
        return (z, z)

    def forward(self, carry, x):
        c, h = carry
        i = torch.sigmoid(self["ii"](x) + self["hi"](h))
        f = torch.sigmoid(self["if"](x) + self["hf"](h))
        g = torch.tanh(self["ig"](x) + self["hg"](h))
        o = torch.sigmoid(self["io"](x) + self["ho"](h))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class RecurrentHead(nn.Module):
    """(feats, th_pos_flat, hidden) -> (out (B, out_dim), new hidden): one
    step of each of ``num_hidden`` cells, the first fed the head input and
    each next one the previous cell's output."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 64,
                 num_hidden: int = 1, cell_type: str = "lstm",
                 out_bias: Optional[Sequence[float]] = None):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"unknown cell_type {cell_type!r}; expected "
                             "'gru' or 'lstm'")
        cell = LSTMCell if cell_type == "lstm" else GRUCell
        self.cells = nn.ModuleList(
            cell(in_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(num_hidden))
        self.out = _OutDense(hidden_dim, out_dim, out_bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for cell in self.cells:
            cell.reset_parameters(generator)
        self.out.init_(generator)

    def initialize_carry(self, batch: int) -> tuple:
        """Zero carry of every cell (flax's default carry init)."""
        like = self.out.weight
        return tuple(c.zero_carry(batch, like) for c in self.cells)

    def forward(self, feats: torch.Tensor, th_pos_flat: torch.Tensor,
                hidden: tuple):
        x = torch.cat([feats, th_pos_flat], dim=-1).to(self.out.weight.dtype)
        new_hidden = []
        for cell, h in zip(self.cells, hidden):
            h, x = cell(h, x)
            new_hidden.append(h)
        return self.out(x), tuple(new_hidden)


def traj_positions_flat(th: torch.Tensor, pos_dim: int = 2) -> torch.Tensor:
    """(B, T+1, D) -> (B, (T+1)·pos_dim): the head's trajectory input, the
    xy (xyz in 3-D) positions of the states."""
    return th[..., :pos_dim].reshape(th.shape[0], -1)
