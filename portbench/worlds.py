"""The cells' problems: forest worlds, their SDFs, far-apart start-goal pairs.

The forest family of the reference's dataset generator (mhmukadam/dgpmp2
``datasets/generate_2d_dataset.py``, as the port carries it in
``dgpmp2_tpu_torch/data/obstacles.py`` and ``data/generate.py``), made on
the device for every world of the bank at once.  Its rules, frozen here:

* a world's start-goal pairs first: uniform a metre inside the world, a
  pair redrawn until its two ends lie at least ``DIST_FACTOR`` of the
  world's diagonal apart;
* then 23 to 44 boxes of ``max(2, size // 30)`` or one more pixel a side,
  centres uniform where the box fits, by rejection: a candidate is kept if
  the box grown by ``ceil(patch_obs / 2)`` pixels each way clears every box
  kept before, and the box clears a square of ``ceil(patch_pts / 2)``
  pixels each way around every start and goal; at most 200 candidates a
  world;
* the robot's clearance sets both patches: three robot radii in pixels.

The draws come from a ``torch.Generator`` on the device, in bulk, so the
maps are the family's but not the numpy generator's draw for draw.

The SDF is the exact Euclidean one, ``(edt(occupied) - edt(free)) * res``
on the map padded by one free pixel, as a dense min-plus pass per axis in
int32, on the device.
"""
from __future__ import annotations

import math

import torch

DIST_FACTOR = 0.6  # least start-goal distance, as a share of the diagonal
MAX_TRIES = 200


def clearance_patches(im_size: int, x_lims, radius: float):
    """The forest family's (patch_pts, patch_obs) in pixels: three robot
    radii around each start and goal, and between boxes."""
    res = (x_lims[1] - x_lims[0]) / im_size
    patch_robot = math.ceil(radius / res)
    return 3 * patch_robot, 3 * patch_robot


def start_goal(gen: torch.Generator, shape, x_lims, y_lims, device):
    """Start and goal positions (*shape, 2) float64, each pair redrawn until
    far enough apart."""
    lo = torch.tensor([x_lims[0] + 1.0, y_lims[0] + 1.0], dtype=torch.float64,
                      device=device)
    span = torch.tensor([x_lims[1] - x_lims[0] - 2.0,
                         y_lims[1] - y_lims[0] - 2.0], dtype=torch.float64,
                        device=device)
    diag = math.hypot(x_lims[1] - x_lims[0], y_lims[1] - y_lims[0])

    def draw():
        u = torch.rand((*shape, 2, 2), generator=gen, device=device,
                       dtype=torch.float64)
        return lo + span * u

    pair = draw()
    while True:
        bad = (pair[..., 1, :] - pair[..., 0, :]).norm(dim=-1) < DIST_FACTOR * diag
        if not bool(bad.any()):
            return pair[..., 0, :], pair[..., 1, :]
        pair = torch.where(bad[..., None, None], draw(), pair)


def _span(centre, half, n):
    """[centre - half, centre + half) clipped to [0, n)."""
    return (centre - half).clamp(0, n), (centre + half).clamp(0, n)


def _meets(a0, a1, b0, b1):
    return torch.maximum(a0, b0) < torch.minimum(a1, b1)


def forest_maps(gen: torch.Generator, pix: torch.Tensor, im_size: int,
                patch_pts: int, patch_obs: int) -> torch.Tensor:
    """Forest maps (W, H, W) float32, 1.0 free and 0.0 obstacle, for the
    worlds whose starts and goals sit at pixels ``pix`` (W, K, 2) (column,
    row)."""
    dev = pix.device
    worlds = pix.shape[0]
    w0 = max(2, im_size // 30)
    num = torch.randint(23, 45, (worlds,), generator=gen, device=dev)
    cap = 44
    rows = torch.zeros((worlds, cap, 2), dtype=torch.int64, device=dev)
    cols = torch.zeros((worlds, cap, 2), dtype=torch.int64, device=dev)
    placed = torch.zeros(worlds, dtype=torch.int64, device=dev)
    slot = torch.arange(cap, device=dev)
    p2, pad = math.ceil(patch_pts / 2), math.ceil(patch_obs / 2)
    py, px = torch.ceil(pix[..., 1]).long(), torch.ceil(pix[..., 0]).long()
    pr0, pr1 = (py - p2).clamp(0, im_size), (py + p2).clamp(0, im_size)
    pc0, pc1 = (px - p2).clamp(0, im_size), (px + p2).clamp(0, im_size)
    for _ in range(MAX_TRIES):
        size = torch.randint(w0, w0 + 2, (2, worlds), generator=gen,
                             device=dev)
        half = (size + 1) // 2  # ceil(size / 2)
        u = torch.rand((2, worlds), generator=gen, device=dev,
                       dtype=torch.float64)
        lo, hi = half, im_size - 1 - half
        centre = lo + (u * (hi - lo + 1)).long().clamp(max=hi - lo)
        cy, cx = centre[0], centre[1]
        hh, hw = half[0], half[1]
        gr0, gr1 = _span(cy, hh + pad, im_size)
        gc0, gc1 = _span(cx, hw + pad, im_size)
        kept = slot[None] < placed[:, None]
        hit = (kept & _meets(gr0[:, None], gr1[:, None], rows[..., 0],
                             rows[..., 1])
               & _meets(gc0[:, None], gc1[:, None], cols[..., 0],
                        cols[..., 1])).any(-1)
        br0, br1 = _span(cy, hh, im_size)
        bc0, bc1 = _span(cx, hw, im_size)
        hit |= (_meets(br0[:, None], br1[:, None], pr0, pr1)
                & _meets(bc0[:, None], bc1[:, None], pc0, pc1)).any(-1)
        take = ~hit & (placed < num)
        at = (slot[None] == placed[:, None]) & take[:, None]
        rows = torch.where(at[..., None], torch.stack([br0, br1], -1)[:, None],
                           rows)
        cols = torch.where(at[..., None], torch.stack([bc0, bc1], -1)[:, None],
                           cols)
        placed = placed + take.long()
    grid = torch.arange(im_size, device=dev)
    occ = torch.zeros((worlds, im_size, im_size), dtype=torch.bool, device=dev)
    for j in range(cap):
        inside = (j < placed)[:, None, None]
        r = (grid >= rows[:, j, :1]) & (grid < rows[:, j, 1:])
        c = (grid >= cols[:, j, :1]) & (grid < cols[:, j, 1:])
        occ |= inside & r[:, :, None] & c[:, None, :]
    return (~occ).to(torch.float32)


def forest_bank(gen: torch.Generator, worlds: int, pairs: int, im_size: int,
                x_lims, y_lims, radius: float, device):
    """``worlds`` forest maps (worlds, H, W) float32 and ``pairs`` start and
    goal positions on each, (worlds, pairs, 2) float64, on ``device``."""
    res = (x_lims[1] - x_lims[0]) / im_size
    start, goal = start_goal(gen, (worlds, pairs), x_lims, y_lims, device)
    ends = torch.cat([start, goal], dim=1)
    pix = torch.stack([-x_lims[0] / res + ends[..., 0] / res,
                       -y_lims[0] / res - ends[..., 1] / res], dim=-1)
    patch_pts, patch_obs = clearance_patches(im_size, x_lims, radius)
    return forest_maps(gen, pix, im_size, patch_pts, patch_obs), start, goal


EDT_CHUNK_BYTES = 1 << 30


def _edt_1d_sq(cost: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = min_j cost[..., j] + (i - j)^2`` along the last axis,
    the output axis in chunks of at most ``EDT_CHUNK_BYTES``."""
    n = cost.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=cost.device)
    lanes = cost.numel() // max(n, 1)
    k = max(1, min(n, EDT_CHUNK_BYTES // max(lanes * n * 4, 1)))
    outs = []
    for s in range(0, n, k):
        pair = (idx[s:s + k, None] - idx[None, :]) ** 2
        outs.append(torch.amin(cost[..., None, :] + pair, dim=-1))
    return torch.cat(outs, dim=-1)


def edt(mask: torch.Tensor) -> torch.Tensor:
    """Euclidean distance in pixels from each cell of (..., H, W) to the
    nearest True cell (float32; ``sqrt(H² + W² + 1)`` with none)."""
    h, w = mask.shape[-2:]
    cap = h * h + w * w + 1
    cost = torch.where(mask, 0, cap).to(torch.int32)
    cost = _edt_1d_sq(cost.transpose(-1, -2)).transpose(-1, -2)
    cost = _edt_1d_sq(cost)
    return torch.sqrt(torch.clamp(cost, max=cap).to(torch.float32))


def sdf_from_map(maps: torch.Tensor, res: float) -> torch.Tensor:
    """Signed distance in metres (positive in free space) of (..., H, W)
    maps, free where > 0.75, padded by one free pixel and cropped back."""
    free = torch.nn.functional.pad((maps > 0.75).to(torch.uint8),
                                   (1, 1, 1, 1), value=1).bool()
    out = (edt(~free) - edt(free)) * res
    return out[..., 1:-1, 1:-1]


def straight_line(start: torch.Tensor, goal: torch.Tensor, horizon: float,
                  steps: int) -> torch.Tensor:
    """(B, 2) positions -> (B, steps + 1, 4) states: positions from start to
    goal at constant velocity, that velocity in every state."""
    alpha = torch.linspace(0.0, 1.0, steps + 1, dtype=start.dtype,
                           device=start.device)
    pos = (start[:, None, :] * (1.0 - alpha)[:, None]
           + goal[:, None, :] * alpha[:, None])
    vel = ((goal - start) / float(horizon))[:, None, :].expand(pos.shape)
    return torch.cat([pos, vel], dim=-1)
