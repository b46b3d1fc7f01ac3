"""Checkpoint and resume; the JAX package's flat-variables format.

Port of ``dgpmp2_tpu/learn/checkpoints.py``, where orbax becomes
``torch.save``.  A checkpoint is one file ``<ckpt_dir>/<step>.pt`` holding
the step, the weights, the optimizer's state, the generator state of the
run (``rng``: the numpy shuffle state, so that a resumed run draws the
batches an uninterrupted one would) and the train/validation split; the
``max_to_keep`` newest steps are kept.

:func:`save_flat_variables` / :func:`load_flat_variables` read and write the
JAX package's deployment format: one ``.npz`` of the flax variable tree's
leaves ``v0 … vN`` in flax's flatten order (dict keys sorted at every
level), kernels in flax's layouts, so that a model trained by either
package loads in the other.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.learn.train import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir) -> list:
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(int(m[1]) for m in map(_NAME.match, os.listdir(d)) if m)


def save(ckpt_dir: str, step: int, state: TrainState, rng=None,
         split: Optional[dict] = None, max_to_keep: int = 5) -> None:
    """Write the snapshot of ``step`` (replacing one of the same step), then
    drop all but the ``max_to_keep`` newest."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": int(state.step),
        "variables": state.variables.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "rng": rng,
        "split": None if split is None else {
            k: np.asarray(v).tolist() for k, v in split.items()},
    }
    tmp = d / f".{step}.pt.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, d / f"{step}.pt")
    for old in _steps(d)[:-max_to_keep]:
        (d / f"{old}.pt").unlink()


def restore(ckpt_dir: str, template: dict, step: Optional[int] = None):
    """Load the newest (or the given) snapshot into ``template["state"]``'s
    weights and optimizer, in place, on their device: ``(step, {"state":
    TrainState, "rng": ..., "split": ...})``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = template["state"]
    dev = next(state.variables.parameters()).device
    payload = torch.load(Path(ckpt_dir) / f"{step}.pt", map_location=dev,
                         weights_only=True)
    state.variables.load_state_dict(payload["variables"])
    state.optimizer.load_state_dict(payload["optimizer"])
    restored = TrainState(step=payload["step"], variables=state.variables,
                          optimizer=state.optimizer)
    return step, {"state": restored, "rng": payload["rng"],
                  "split": payload["split"]}


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _flat_leaves(tree, path=()):
    """(path, leaf) in flax's flatten order: dict keys sorted at every
    level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k],
                                                               path + (k,))]
    return [(path, tree)]


def save_flat_variables(path: str, variables: nn.ModuleDict) -> None:
    """The learned planner's weights as the JAX package's flat ``.npz``
    (leaves ``v0 … vN`` of its flax variable tree)."""
    leaves = _flat_leaves(convert.learned_state_to_flax(variables))
    np.savez(path, **{f"v{i}": a for i, (_, a) in enumerate(leaves)})


def load_flat_variables(path: str, template: nn.ModuleDict) -> nn.ModuleDict:
    """Load a flat ``.npz`` (written by either package) into ``template``,
    the learned planner's ``variables`` of the same architecture, in place
    and in its dtype; returns it."""
    loaded = np.load(path, allow_pickle=False)
    leaves = _flat_leaves(convert.learned_flax_shapes(template))
    if len(loaded.files) != len(leaves):
        raise ValueError(
            f"{path} holds {len(loaded.files)} leaves, template has "
            f"{len(leaves)}: mismatched architecture?")
    tree: dict[str, Any] = {}
    for i, (p, shape) in enumerate(leaves):
        a = loaded[f"v{i}"]
        if list(a.shape) != list(shape):
            raise ValueError(f"leaf v{i} {'/'.join(p)}: shape {a.shape}, "
                             f"template {tuple(shape)}")
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = a
    ref = next(template.parameters())
    state = {k: v.to(dtype=ref.dtype, device=ref.device)
             for k, v in convert.learned_state_from_flax(tree).items()}
    template.load_state_dict(state)
    return template
