"""Carry state across from the JAX package as numpy arrays.

The JAX side hands over ``{f: np.asarray(getattr(p, f)) for f in fields}``
(``None`` kept as ``None``); the port hands back plain numpy.

Network weights cross as the flax variable tree in nested dicts of numpy
arrays: :func:`learned_state_from_flax` maps the learned planner's
``{"conv": {"params": ...}, "head": {"params": ...}}`` onto the state dict
of its ``variables`` (``LearnedDiffGPMP2Planner.init_variables``),
:func:`learned_state_to_flax` back, and
:func:`module_state_from_flax` one module's ``params`` tree (an ``InitNet``,
an encoder, a head) onto its port's (:func:`module_state_to_flax` back);
:func:`learned_grads_to_flax` and :func:`module_grads_to_flax` carry
gradients back as flax trees.  Flax
names map one to one: ``Conv_i`` → ``convs.i``, ``LayerNorm_i`` →
``norms.i``, ``Dense_i`` → ``dense.i`` (the last Dense → ``out``),
``cell{i}/{ir, …}`` → ``cells.i.{ir, …}``, ``ConvEncoder_0`` → ``encoder``.
Kernels transpose: a Dense (in, out) is a Linear weight (out, in), a conv
(k…, cin, cout) a (cout, cin, k…) weight; LayerNorm's ``scale`` is
``weight``.  Weights sharded over a device mesh
(``parallel.sharding.ShardedParams``) cross as the same tree of full
kernels: :func:`learned_sharded_to_flax` joins the slices,
:func:`learned_sharded_from_flax` loads the tree and shards it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch import nn

from dgpmp2_tpu_torch.core.gn import PlanResult
from dgpmp2_tpu_torch.core.graph import GraphParams
from dgpmp2_tpu_torch.parallel import sharding


def graph_params_from_numpy(arrays: dict, device: torch.device | str,
                            dtype: torch.dtype) -> GraphParams:
    """GraphParams on ``device`` from a dict of numpy arrays (or ``None``)."""
    names = {f.name for f in dataclasses.fields(GraphParams)}
    unknown = set(arrays) - names
    if unknown:
        raise ValueError(f"not GraphParams fields: {sorted(unknown)}")
    return GraphParams(**{
        k: None if v is None else torch.tensor(np.asarray(v), dtype=dtype,
                                               device=device)
        for k, v in arrays.items()
    })


def plan_result_to_numpy(result: PlanResult) -> dict:
    """Every field of a PlanResult as a numpy array (``None`` kept)."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in result._asdict().items()}


def _to_torch_leaf(kind: str, leaf: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if leaf == "kernel":
        a = a.T if kind == "dense" else np.moveaxis(
            a, (a.ndim - 1, a.ndim - 2), (0, 1))
    return torch.tensor(np.ascontiguousarray(a))


def _to_flax_leaf(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return a.T if kind == "dense" else np.moveaxis(
            a, (0, 1), (a.ndim - 1, a.ndim - 2))
    return a


_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _from_flax(params: dict, prefix: str, out: dict) -> None:
    denses = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("Dense_"))
    for key, sub in params.items():
        kind, _, idx = key.partition("_")
        if key.startswith("cell"):
            items = [(f"cells.{key[4:]}.{n}", "dense", v)
                     for n, v in sub.items()]
        elif kind == "ConvEncoder":
            _from_flax(sub, prefix + "encoder.", out)
            continue
        elif kind == "Conv":
            items = [(f"convs.{idx}", "conv", sub)]
        elif kind == "LayerNorm":
            items = [(f"norms.{idx}", "norm", sub)]
        elif kind == "Dense":
            name = "out" if int(idx) == denses[-1] else f"dense.{idx}"
            items = [(name, "dense", sub)]
        else:
            raise ValueError(f"no counterpart for flax module {key!r}")
        for name, k, leaves in items:
            for leaf, a in leaves.items():
                out[f"{prefix}{name}.{_TORCH_LEAF[leaf]}"] = _to_torch_leaf(
                    k, leaf, a)


def learned_state_from_flax(variables_np: dict) -> dict:
    """The learned planner's flax variables (nested numpy) -> the state dict
    of its ``variables`` ModuleDict (CPU tensors in the arrays' dtype; load
    with ``variables.load_state_dict``)."""
    out = {}
    for part in ("conv", "head"):
        _from_flax(variables_np[part]["params"], f"{part}.", out)
    return out


def module_state_from_flax(params_np: dict) -> dict:
    """One flax module's ``params`` tree (a ``ConvEncoder``, a head or an
    ``InitNet``) -> the state dict of its port in ``dgpmp2_tpu_torch.models``."""
    out = {}
    _from_flax(params_np, "", out)
    return out


def _flax_path(module: nn.Module, name: str):
    """(flax path, kind, leaf) of a parameter ``name`` of ``module``."""
    parts = name.split(".")
    if parts[0] == "encoder":
        path, kind, leaf = _flax_path(module.encoder, ".".join(parts[1:]))
        return ("ConvEncoder_0",) + path, kind, leaf
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "cells":
        return (f"cell{parts[1]}", parts[2]), "dense", leaf
    if parts[0] == "out":
        n = len(module.dense) if hasattr(module, "dense") else 0
        return (f"Dense_{n}",), "dense", leaf
    kind, flax_name = {"convs": ("conv", "Conv"), "norms": ("norm", "LayerNorm"),
                       "dense": ("dense", "Dense")}[parts[0]]
    if kind == "norm" and leaf == "kernel":
        leaf = "scale"
    return (f"{flax_name}_{parts[1]}",), kind, leaf


def _module_tree(module: nn.Module, leaf_fn) -> dict:
    """A flax ``params`` tree over the parameters of ``module``, each leaf
    ``leaf_fn(kind, leaf, parameter)``."""
    tree = {}
    for name, p in module.named_parameters():
        path, kind, leaf = _flax_path(module, name)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = leaf_fn(kind, leaf, p)
    return tree


def module_grads_to_flax(module: nn.Module) -> dict:
    """The ``.grad`` of every parameter of ``module`` (an encoder, a head or
    an ``InitNet``) as a flax ``params`` tree of numpy arrays (None where a
    parameter has no gradient)."""
    return _module_tree(module, lambda kind, leaf, p: None if p.grad is None
                        else _to_flax_leaf(kind, leaf,
                                           p.grad.detach().cpu().numpy()))


def module_state_to_flax(module: nn.Module) -> dict:
    """One module's weights as its flax ``params`` tree of numpy arrays (the
    inverse of :func:`module_state_from_flax`)."""
    return _module_tree(module, lambda kind, leaf, p: _to_flax_leaf(
        kind, leaf, p.detach().cpu().numpy().copy()))


def module_flax_shapes(module: nn.Module) -> dict:
    """The shapes of one module's flax ``params`` tree."""
    return _module_tree(module, lambda kind, leaf, p: list(_to_flax_leaf(
        kind, leaf, np.empty(tuple(p.shape), np.uint8)).shape))


def learned_flax_shapes(variables: nn.ModuleDict) -> dict:
    """The shapes of the learned planner's flax variable tree, from its
    port's ``variables`` (for :func:`seeded_flax_tree` without JAX)."""
    def shape(kind, leaf, p):
        return list(_to_flax_leaf(kind, leaf, np.empty(tuple(p.shape),
                                                       np.uint8)).shape)

    return {part: {"params": _module_tree(variables[part], shape)}
            for part in ("conv", "head")}


def learned_state_to_flax(variables: nn.ModuleDict) -> dict:
    """The learned planner's weights as its flax variable tree of numpy
    arrays (the inverse of :func:`learned_state_from_flax`)."""
    def leaf(kind, name, p):
        return _to_flax_leaf(kind, name, p.detach().cpu().numpy().copy())

    return {part: {"params": _module_tree(variables[part], leaf)}
            for part in ("conv", "head")}


def learned_grads_to_flax(variables: nn.ModuleDict) -> dict:
    """The learned planner's gradients as its flax variable tree
    ``{"conv": {"params": ...}, "head": {"params": ...}}``."""
    return {part: {"params": module_grads_to_flax(variables[part])}
            for part in ("conv", "head")}


def learned_sharded_to_flax(sharded: "sharding.ShardedParams") -> dict:
    """Sharded learned-planner weights as the JAX package's flax variable
    tree of full kernels (the slices joined on the CPU,
    ``sharding.join_params``)."""
    return learned_state_to_flax(sharding.join_params(sharded, "cpu"))


def learned_sharded_from_flax(variables_np: dict, planner, im_stack, th,
                              mesh: "sharding.Mesh"
                              ) -> "sharding.ShardedParams":
    """The inverse of :func:`learned_sharded_to_flax`: the flax tree loaded
    into ``planner``'s network (``load_variables`` for ``im_stack`` and
    ``th``) and sharded over ``mesh``."""
    return sharding.shard_params(planner.load_variables(
        learned_state_from_flax(variables_np), im_stack, th), mesh)


def seeded_flax_tree(shapes: dict, seed: int, out_path=None, out_bias=None,
                     out_scale: float = 0.05) -> dict:
    """Random weights for a flax variable tree of ``shapes`` (nested dicts
    of shape lists), made with numpy from ``seed`` so that both packages
    can remake them: a kernel N(0, 1/fan_in), a bias N(0, 0.01), a
    LayerNorm scale 1 + N(0, 0.01), drawn leaf by leaf in sorted key order.
    The module at ``out_path`` (the head's output Dense) gets its kernel
    scaled by ``out_scale`` and ``out_bias`` (if given) plus ``out_scale``
    times its draw as bias: random weights about a static initialisation."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in sorted(node)}
        shape, leaf = tuple(node), path[-1]
        a = rng.standard_normal(shape)
        if leaf == "kernel":
            a = a / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        if out_path is not None and path[:-1] == tuple(out_path):
            a = a * out_scale
            if leaf == "bias" and out_bias is not None:
                a = a + np.asarray(out_bias, np.float64)
        return a

    return walk(shapes, ())


def learned_out_path(shapes: dict) -> tuple:
    """The path of the learned planner head's output Dense in its flax
    tree: the head's Dense of the highest index."""
    head = shapes["head"]["params"]
    n = max(int(k.split("_")[1]) for k in head if k.startswith("Dense_"))
    return ("head", "params", f"Dense_{n}")
