"""Multi-device sharding: device meshes, batch sharding, TP parameter rules.

Port of ``dgpmp2_tpu/parallel/sharding.py``.  JAX annotates shardings and
lets GSPMD place the work; here a :class:`Mesh` is a small named array of
``torch.device`` entries shaped ``(data, model)``, and the data-parallel
split is explicit: :func:`shard_batch` cuts the leading (problem) axis of
every tensor of a batch into one chunk per ``data`` row of the mesh, on
that row's first device, and :func:`gather_batch` joins the chunks again.
Planning needs no communication between problems, so a sharded plan is
one plan per shard (``serve.PlanningService(mesh=)`` does exactly that).

The tensor-parallel rules of the learned head (a Megatron column split of
the first wide projection, a row split of the second) are kept:
:func:`param_spec` gives each parameter's spec by the JAX package's rules,
matched on the port's parameter names, and :func:`shard_params` /
:func:`shard_state` place every parameter on every device of the mesh and
record its spec.  Executing that split across several cards, and a
data-parallel training step over the mesh, are not ported yet (ROADMAP).

Entries may repeat: a mesh of ``[torch.device("cpu")] * 8`` runs on the
CPU, as the JAX tests' eight virtual CPU devices do.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from dgpmp2_tpu_torch.utils.tree import leaves, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None``: not split), JAX's ``P``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` entries, one axis
    per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def data_devices(self) -> list:
        """The device of each batch shard: the first of each row along the
        data axes (``("dcn", "data")`` jointly on a multi-host mesh)."""
        rows = self.devices.reshape(-1, self.shape[MODEL_AXIS])
        return [row[0] for row in rows]


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def make_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1,
              strict: bool = False) -> Mesh:
    """2-D ``(data, model)`` mesh over ``devices`` (default: every visible
    CUDA device).  With ``model_parallel=1`` this is pure data
    parallelism; ``model`` is the inner axis.  A device count that
    ``model_parallel`` does not divide warns and falls back to
    ``model_parallel=1``, or raises under ``strict``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n % model_parallel:
        if strict:
            raise ValueError(
                f"{n} devices not divisible by model_parallel={model_parallel}"
            )
        warnings.warn(
            f"{n} devices not divisible by model_parallel={model_parallel}; "
            "falling back to model_parallel=1 (pure data parallelism). "
            "Pass strict=True to make this an error.")
        model_parallel = 1
    return Mesh(_device_array(devices, (n // model_parallel, model_parallel)),
                (DATA_AXIS, MODEL_AXIS))


def make_multihost_mesh(model_parallel: int = 1,
                        devices: Optional[Sequence] = None) -> Mesh:
    """3-axis ``(dcn, data, model)`` mesh.  The port runs one process: the
    outer ``dcn`` (host) axis has size 1, and the mesh is
    :func:`make_mesh`'s with that axis in front."""
    mesh = make_mesh(devices, model_parallel, strict=True)
    return Mesh(mesh.devices[None], (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axes (``("dcn", "data")``
    jointly on a multi-host mesh, else ``"data"``)."""
    if DCN_AXIS in mesh.axis_names:
        return NamedSharding(mesh, P((DCN_AXIS, DATA_AXIS)))
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Any, mesh: Mesh) -> list:
    """The batch cut along its leading axis into one chunk per data shard
    of the mesh (:meth:`Mesh.data_devices`), each on its device: a list of
    pytrees shaped as ``batch``.  The leading axis must divide evenly."""
    devices = mesh.data_devices()
    n = len(devices)

    def chunks(x):
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} not divisible by "
                             f"{n} data shards")
        return x.chunk(n)

    return [tree_map(lambda x, i=i, d=d: chunks(x)[i].to(d), batch)
            for i, d in enumerate(devices)]


def gather_batch(shards: Sequence, device=None) -> Any:
    """The inverse of :func:`shard_batch`: the chunks joined along the
    leading axis on ``device`` (default: the first chunk's)."""
    first = leaves(shards[0])
    device = first[0].device if device is None else torch.device(device)
    cols = iter(zip(*(leaves(s) for s in shards)))
    return tree_map(lambda _: torch.cat([x.to(device) for x in next(cols)]),
                    shards[0])


# Megatron-style TP of the covariance head's wide Linear stack, as the JAX
# package's rules (``head.*Dense_0.*kernel`` column-split, ``Dense_1``
# row-split, ``Dense_0`` bias split), on the port's names: flax's Dense_i
# is ``head.dense.i`` and a Linear weight is the (out, in) transpose of
# flax's (in, out) kernel, so its spec is the kernel's reversed.
_TP_RULES = (
    (re.compile(r"head.*dense\.0.*weight"), P(MODEL_AXIS, None)),
    (re.compile(r"head.*dense\.1.*weight"), P(None, MODEL_AXIS)),
    (re.compile(r"head.*dense\.0.*bias"), P(MODEL_AXIS)),
)


def param_spec(path: str, shape) -> PartitionSpec:
    for pat, spec in _TP_RULES:
        if pat.search(path) and len(spec) <= len(shape):
            return spec
    return P()


@dataclasses.dataclass
class ShardedParams:
    """Every parameter on every device of the mesh (``replicas``: one
    name -> tensor dict per device, in the mesh's flat order) with its TP
    spec (``specs``), recorded for the tensor-parallel split."""

    mesh: Mesh
    specs: dict
    replicas: list


def _named_tensors(variables) -> dict:
    if isinstance(variables, torch.nn.Module):
        return dict(variables.state_dict(keep_vars=True))
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(tree, torch.Tensor):
            out[prefix] = tree
    walk(variables, "")
    return out


def shard_params(variables, mesh: Mesh) -> ShardedParams:
    """Place each parameter of ``variables`` (a module, or a nested dict of
    tensors named by their dotted paths) on every device of the mesh, with
    its :func:`param_spec` (replicated unless a TP rule matches)."""
    named = _named_tensors(variables)
    specs = {k: param_spec(k, v.shape) for k, v in named.items()}
    replicas = [{k: v.detach().to(d) for k, v in named.items()}
                for d in mesh.devices.reshape(-1)]
    return ShardedParams(mesh, specs, replicas)


@dataclasses.dataclass
class ShardedState:
    step: int
    variables: ShardedParams
    opt_state: ShardedParams


def shard_state(state, mesh: Mesh) -> ShardedState:
    """Shard a ``learn.train.TrainState``: the variables and the
    optimizer's per-parameter state by the TP rules (an optimizer state
    tensor named ``<parameter>.<key>``), the step replicated."""
    names = {id(p): k for k, p in
             state.variables.named_parameters()}
    opt = {f"{names[id(p)]}.{key}": v
           for p, s in state.optimizer.state.items()
           for key, v in s.items() if isinstance(v, torch.Tensor)}
    return ShardedState(step=state.step,
                        variables=shard_params(state.variables, mesh),
                        opt_state=shard_params(opt, mesh))
