"""Pytrees of tensors: nested tuples, lists, dicts and dataclasses (such
as ``core.graph.GraphParams``), with ``None`` and other leaves kept as
they are."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree):
    """``fn`` on every tensor of ``tree``, the structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def leaves(tree) -> list:
    """The tensors of ``tree``, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out
