"""Multi-device sharding: device meshes, batch sharding, the learned head's
tensor-parallel split and the reductions that tie the shards together.

Port of ``dgpmp2_tpu/parallel/sharding.py``.  JAX annotates shardings and
lets GSPMD place the work and insert the collectives; here every piece is
explicit.

* A :class:`Mesh` is a small named array of ``torch.device`` entries shaped
  ``(data, model)``, or ``(dcn, data, model)`` across processes
  (:func:`make_multihost_mesh`), where each process holds the rows of its
  own devices.  Entries may repeat: a mesh of ``[torch.device("cpu")] * 8``
  runs on the CPU as the JAX tests' eight virtual CPU devices do, and a
  mesh of two entries of one card runs its shards one after the other.
* :func:`shard_batch` cuts the leading (problem) axis of a batch into one
  chunk per data shard, each on its data row's first device, and
  :func:`gather_batch` joins the chunks again, across processes too.
* :func:`shard_params` gives each device its own shard of a module: a
  parameter with a ``model`` spec (:func:`param_spec`, the JAX package's
  Megatron rules: ``head.dense.0`` column-split, ``head.dense.1`` row-split)
  keeps only its slice on each model-axis device, every other parameter a
  full replica; :func:`shard_state` splits the optimizer's per-parameter
  state the same way.  :func:`join_params` / :func:`unshard_state` join the
  slices back into one module (checkpoints stay unsharded).
* Reductions.  In one process a reduction over devices is an explicit sum
  onto the first device and a copy back, as autograd functions whose
  backward is the matching broadcast or sum (Megatron's *f*/*g* pair):
  :func:`broadcast`, :func:`sum_to`, :func:`all_reduce`.  Across processes
  (the ``dcn`` axis) :func:`process_all_reduce` / :func:`process_all_gather`
  go through ``torch.distributed`` on the backend the caller initialised
  the process group with, never another: ``nccl`` when each rank has its
  own card, ``gloo`` on the CPU and when ranks share a card, where the
  tensors are staged through host memory.  Only data-parallel traffic
  crosses ``dcn`` (the output gather and the gradient all-reduce);
  ``model`` stays inside one process.
* :func:`reduce_grads` and :func:`clip_grads` finish a data-parallel
  backward pass: every device's gradient becomes the sum over the devices
  that hold the same slice (and over processes), and the global norm counts
  each slice and each replicated parameter once.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import re
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

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
    """``devices``: an object array of this process's ``torch.device``
    entries, one axis per name in ``axis_names`` (on a multi-process mesh
    the ``dcn`` axis of ``devices`` has size 1: this process's row);
    ``process_count`` processes along ``dcn``, this one at
    ``process_index``."""

    devices: np.ndarray
    axis_names: tuple
    process_count: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict:
        shape = dict(zip(self.axis_names, self.devices.shape))
        if DCN_AXIS in shape:
            shape[DCN_AXIS] = self.process_count
        return shape

    @property
    def size(self) -> int:
        return self.devices.size * self.process_count

    @property
    def model_parallel(self) -> int:
        return self.shape[MODEL_AXIS]

    def data_devices(self) -> list:
        """The device of each of this process's batch shards: the first of
        each row along the data axes."""
        return [row[0] for row in
                self.devices.reshape(-1, self.model_parallel)]

    @property
    def num_data_shards(self) -> int:
        """Batch shards over every process: ``dcn`` × ``data``."""
        return len(self.data_devices()) * self.process_count


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
    """3-axis ``(dcn, data, model)`` mesh.  Once a ``torch.distributed``
    process group is initialised, ``dcn`` is its world size and this
    process holds the ``(data, model)`` rows of its local ``devices``
    (default: every visible CUDA device; every process must give as many);
    without one, ``dcn`` has size 1 and the mesh is :func:`make_mesh`'s
    with that axis in front.  The batch splits over ``(dcn, data)``
    jointly; ``model`` stays inside each process."""
    local = make_mesh(devices, model_parallel, strict=True)
    count, index = ((dist.get_world_size(), dist.get_rank())
                    if dist.is_initialized() else (1, 0))
    return Mesh(local.devices[None], (DCN_AXIS, DATA_AXIS, MODEL_AXIS),
                count, index)


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


def row_bounds(n: int, mesh: Mesh) -> list:
    """``(start, stop)`` rows of each of this process's batch shards when
    ``n`` rows split over all ``mesh.num_data_shards`` shards, the first
    ``n % shards`` of them one row longer; every shard must get a row."""
    shards = mesh.num_data_shards
    if n < shards:
        raise ValueError(f"{n} rows for {shards} data shards")
    base, extra = divmod(n, shards)
    starts = np.cumsum([0] + [base + (g < extra) for g in range(shards)])
    local = len(mesh.data_devices())
    first = mesh.process_index * local
    return [(int(starts[g]), int(starts[g + 1]))
            for g in range(first, first + local)]


def shard_batch(batch: Any, mesh: Mesh) -> list:
    """This process's chunks of ``batch`` (the whole batch, the same on
    every process), cut along its leading axis into one chunk per data
    shard of the mesh, each on its device (:meth:`Mesh.data_devices`): a
    list of pytrees shaped as ``batch``.  The leading axis must divide
    evenly over every process's shards."""
    n = mesh.num_data_shards

    def check(x):
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} not divisible by "
                             f"{n} data shards")

    tree_map(check, batch)
    first = leaves(batch)
    bounds = row_bounds(first[0].shape[0], mesh) if first else []
    return [tree_map(lambda x, a=a, b=b, d=d: x[a:b].to(d), batch)
            for (a, b), d in zip(bounds, mesh.data_devices())]


def gather_batch(shards: Sequence, device=None,
                 mesh: Optional[Mesh] = None) -> Any:
    """The inverse of :func:`shard_batch`: the chunks joined along the
    leading axis on ``device`` (default: the first chunk's); with a
    multi-process ``mesh``, every process's chunks, in process order, on
    every process."""
    first = leaves(shards[0])
    device = first[0].device if device is None else torch.device(device)
    cols = iter(zip(*(leaves(s) for s in shards)))

    def join(_):
        x = torch.cat([x.to(device) for x in next(cols)])
        if mesh is not None and mesh.process_count > 1:
            x = process_all_gather(x, mesh)
        return x

    return tree_map(join, shards[0])


# -- reductions ----------------------------------------------------------------

class _Broadcast(torch.autograd.Function):
    """f: one tensor copied to each device; backward, the copies'
    gradients summed onto the source."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g for g in grads if g is not None]
        return (_sum_on(grads, ctx.device) if grads else None), None


class _SumTo(torch.autograd.Function):
    """g: one tensor a device, summed onto the first one's device in device
    order; backward, the gradient copied back to each device."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return _sum_on(xs, xs[0].device)

    @staticmethod
    def backward(ctx, grad):
        return tuple(grad.to(d, copy=True) for d in ctx.devices)


def _sum_on(xs, device) -> torch.Tensor:
    out = xs[0].to(device, copy=True)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def broadcast(x: torch.Tensor, devices: Sequence) -> list:
    """``x`` on each of ``devices`` (a copy each); its gradient is the sum
    of theirs."""
    return list(_Broadcast.apply(x, [torch.device(d) for d in devices]))


def sum_to(xs: Sequence) -> torch.Tensor:
    """The sum of ``xs`` (one tensor a device) on the first one's device;
    each input's gradient is the sum's."""
    return _SumTo.apply(*xs)


def all_reduce(xs: Sequence) -> list:
    """The sum of ``xs`` (one tensor a device, along a mesh axis) back on
    each of their devices: :func:`sum_to` then :func:`broadcast`."""
    return broadcast(sum_to(xs), [x.device for x in xs])


def _staged(x: torch.Tensor, collective) -> torch.Tensor:
    """Run ``collective(buffer)`` on the process group's backend: under
    ``gloo`` the buffer is a host copy of ``x`` and the result goes back to
    ``x``'s device; under ``nccl`` it is a copy of ``x`` on its card."""
    backend = dist.get_backend()
    if backend == dist.Backend.GLOO:
        return collective(x.detach().to("cpu", copy=True)).to(x.device)
    if backend == dist.Backend.NCCL:
        if x.device.type != "cuda":
            raise ValueError(f"nccl reduces CUDA tensors, not {x.device}")
        return collective(x.detach().clone())
    raise ValueError(f"no collective path for the {backend!r} backend")


def process_all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the processes of the mesh's ``dcn`` axis, on
    ``x``'s device (``x`` itself in one process)."""
    if mesh.process_count == 1:
        return x

    def reduce(buf):
        dist.all_reduce(buf)
        return buf

    return _staged(x, reduce)


def process_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``x`` (the same shape on each), joined along the
    leading axis in process order, on ``x``'s device."""
    if mesh.process_count == 1:
        return x

    def gather(buf):
        parts = [torch.empty_like(buf) for _ in range(mesh.process_count)]
        dist.all_gather(parts, buf)
        return torch.cat(parts)

    return _staged(x, gather)


# -- tensor-parallel parameters ------------------------------------------------

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


def _split_dim(spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _slice(name: str, x: torch.Tensor, spec, j: int, mp: int):
    """Model device ``j``'s slice of ``x`` (all of it when not split)."""
    dim = _split_dim(spec)
    if dim is None or x.ndim <= dim:
        return x
    if x.shape[dim] % mp:
        raise ValueError(f"{name}: dimension {dim} of {tuple(x.shape)} is "
                         f"not divisible by model_parallel={mp}")
    return x.chunk(mp, dim)[j]


def _join(xs: Sequence, spec) -> torch.Tensor:
    """The inverse of :func:`_slice` over the model devices' slices."""
    dim = _split_dim(spec)
    if dim is None or xs[0].ndim <= dim:
        return xs[0]
    return torch.cat([x.to(xs[0].device) for x in xs], dim)


@dataclasses.dataclass
class ShardedParams:
    """One shard of a module (or of a name -> tensor dict) per device of
    this process's part of the mesh, in the mesh's flat order: an
    ``nn.Module`` whose parameters are that device's slices and replicas
    (a dict of them for a dict).  ``specs``: each tensor's spec."""

    mesh: Mesh
    specs: dict
    shards: list

    def named(self, k: int) -> dict:
        """Device ``k``'s tensors by name."""
        shard = self.shards[k]
        if isinstance(shard, nn.Module):
            return dict(shard.state_dict(keep_vars=True))
        return shard

    def group(self, row: int) -> list:
        """The shards of data row ``row``'s devices, in model order."""
        mp = self.mesh.model_parallel
        return self.shards[row * mp:(row + 1) * mp]


def _named_tensors(variables) -> dict:
    if isinstance(variables, nn.Module):
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


def _set_tensor(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Replace the parameter or buffer ``name`` of ``module`` by ``value``
    (a parameter keeps its ``requires_grad``)."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix)
    old = getattr(owner, leaf)
    if isinstance(old, nn.Parameter):
        value = nn.Parameter(value, requires_grad=old.requires_grad)
    setattr(owner, leaf, value)


def shard_params(variables, mesh: Mesh) -> ShardedParams:
    """Each device of the mesh gets its shard of ``variables`` (a module, or
    a nested dict of tensors named by their dotted paths): a tensor with a
    ``model`` spec (:func:`param_spec`) its slice for the device's place on
    the model axis, every other tensor a full replica, each a copy on the
    device.  A split dimension that the model axis does not divide
    raises."""
    named = _named_tensors(variables)
    specs = {k: param_spec(k, v.shape) for k, v in named.items()}
    mp = mesh.model_parallel
    shards = []
    for k, dev in enumerate(mesh.devices.reshape(-1)):
        local = {name: _slice(name, x.detach(), specs[name], k % mp, mp)
                 .to(dev, copy=True) for name, x in named.items()}
        if isinstance(variables, nn.Module):
            shard = copy.deepcopy(variables)
            for name, x in local.items():
                _set_tensor(shard, name, x)
            local = shard
        shards.append(local)
    return ShardedParams(mesh, specs, shards)


def join_params(sharded: ShardedParams, device=None):
    """The full module (or dict) again, on ``device`` (default: the first
    shard's): the slices of each split tensor joined along their model
    axis, replicas taken from the first device; a gradient, where each of
    a tensor's slices has one, joined the same way."""
    group = [sharded.named(k) for k in range(sharded.mesh.model_parallel)]
    device = (next(iter(group[0].values())).device if device is None
              else torch.device(device))
    full = {}
    for name, x in group[0].items():
        spec = sharded.specs[name]
        value = _join([g[name].detach() for g in group], spec).to(
            device, copy=True)
        grads = [g[name].grad for g in group]
        if all(g is not None for g in grads):
            value.grad = _join(grads, spec).to(device, copy=True)
        full[name] = value
    if not isinstance(sharded.shards[0], nn.Module):
        return full
    module = copy.deepcopy(sharded.shards[0])
    for name, value in full.items():
        grad = value.grad
        _set_tensor(module, name, value)
        if grad is not None:
            dict(module.named_parameters())[name].grad = grad
    return module


# -- data-parallel gradients ---------------------------------------------------

def holders(sharded: ShardedParams, name: str) -> list:
    """Lists of the local device indices that hold the same part of
    ``name``: one list a model slice for a split tensor, else one list of
    every device."""
    n = len(sharded.shards)
    mp = sharded.mesh.model_parallel
    if _split_dim(sharded.specs[name]) is None:
        return [list(range(n))]
    return [list(range(j, n, mp)) for j in range(mp)]


def _parameters(sharded: ShardedParams) -> list:
    """Per device, its parameters by name."""
    return [dict(s.named_parameters()) for s in sharded.shards]


def reduce_grads(sharded: ShardedParams) -> None:
    """Finish a data-parallel backward pass: each device's ``.grad`` of each
    parameter becomes the sum of the gradients held, on every device of
    every process, for the same part of it (a model slice, or the whole of
    a replicated parameter), zero where none has one; every device gets its
    own copy, so that the replicas stay equal.  One
    :func:`process_all_reduce` carries every sum across processes."""
    params = _parameters(sharded)
    first = params[0][next(iter(params[0]))].device
    sums = []  # (name, holders, the sum on the mesh's first device)
    for name, p0 in params[0].items():
        for group in holders(sharded, name):
            grads = [params[k][name].grad for k in group
                     if params[k][name].grad is not None]
            total = (_sum_on(grads, first) if grads else
                     torch.zeros_like(params[group[0]][name], device=first))
            sums.append((name, group, total))
    if sharded.mesh.process_count > 1:
        flat = process_all_reduce(torch.cat([s.reshape(-1)
                                             for *_, s in sums]),
                                  sharded.mesh)
        sizes = [s.numel() for *_, s in sums]
        sums = [(n, h, part.view_as(s)) for (n, h, s), part in
                zip(sums, flat.split(sizes))]
    for name, group, total in sums:
        for k in group:
            p = params[k][name]
            p.grad = total.to(p.device, copy=True)


def grad_norm(sharded: ShardedParams) -> torch.Tensor:
    """The global norm of the reduced gradient (:func:`reduce_grads`),
    counting each model slice and each replicated parameter once, on the
    mesh's first device."""
    params = _parameters(sharded)
    first = params[0][next(iter(params[0]))].device
    sq = [torch.sum(params[group[0]][name].grad ** 2).to(first)
          for name in params[0] for group in holders(sharded, name)]
    return torch.sqrt(sum(sq))


def clip_grads(sharded: ShardedParams, clip_val: float) -> torch.Tensor:
    """Scale every device's reduced gradient by ``min(1, clip_val / (‖g‖ +
    1e-9))``, ‖g‖ from :func:`grad_norm` (``learn.train.
    clip_by_global_norm`` over the joined module); returns ‖g‖."""
    gnorm = grad_norm(sharded)
    scale = torch.clamp(clip_val / (gnorm + 1e-9), max=1.0)
    for named in _parameters(sharded):
        for p in named.values():
            p.grad.mul_(scale.to(p.device))
    return gnorm


# -- sharded training state ----------------------------------------------------

@dataclasses.dataclass
class ShardedState:
    """A ``learn.train.TrainState`` over a mesh: the variables' shards and
    one optimizer a device over its shard's parameters, its per-parameter
    state split as they are."""

    step: int
    variables: ShardedParams
    optimizers: list

    @property
    def opt_state(self) -> ShardedParams:
        """The optimizers' tensors by ``<parameter>.<key>``, per device,
        each with its parameter's spec where it has the parameter's
        shape."""
        specs, shards = {}, []
        for k, opt in enumerate(self.optimizers):
            names = {id(p): n for n, p in
                     self.variables.shards[k].named_parameters()}
            shard = {}
            for p, st in opt.state.items():
                for key, v in st.items():
                    if isinstance(v, torch.Tensor):
                        name = f"{names[id(p)]}.{key}"
                        shard[name] = v
                        specs[name] = (self.variables.specs[names[id(p)]]
                                       if v.shape == p.shape else P())
            shards.append(shard)
        return ShardedParams(self.variables.mesh, specs, shards)


def _optimizer_like(optimizer: torch.optim.Optimizer, params):
    """A fresh optimizer of ``optimizer``'s class and settings over
    ``params``."""
    if len(optimizer.param_groups) != 1:
        raise ValueError("a sharded optimizer takes one parameter group")
    cls = type(optimizer)
    takes = inspect.signature(cls.__init__).parameters
    return cls(params, **{k: v for k, v in optimizer.defaults.items()
                          if k in takes})


def _optimizer_state(optimizer, names: list) -> dict:
    """``optimizer.state_dict()['state']`` by parameter name (``names``:
    the names of its parameters in order)."""
    return {names[i]: st for i, st in
            optimizer.state_dict()["state"].items()}


def shard_state(state, mesh: Mesh) -> ShardedState:
    """Shard a ``learn.train.TrainState``: the variables by the TP rules
    (:func:`shard_params`), and on each device an optimizer of the state's
    class and settings over that device's parameters, holding the slices
    of the optimizer's per-parameter state that match its parameters'."""
    variables = shard_params(state.variables, mesh)
    mp = mesh.model_parallel
    shapes = {n: p.shape for n, p in state.variables.named_parameters()}
    by_id = {id(p): n for n, p in state.variables.named_parameters()}
    order = [by_id[id(p)] for p in state.optimizer.param_groups[0]["params"]]
    full = _optimizer_state(state.optimizer, order)
    optimizers = []
    for k, shard in enumerate(variables.shards):
        named = dict(shard.named_parameters())
        opt = _optimizer_like(state.optimizer, [named[n] for n in order])
        sd = opt.state_dict()
        sd["state"] = {
            i: {key: (_slice(n, v, variables.specs[n], k % mp, mp).clone()
                      if isinstance(v, torch.Tensor) and v.shape == shapes[n]
                      else v)
                for key, v in full[n].items()}
            for i, n in enumerate(order) if n in full}
        opt.load_state_dict(sd)
        optimizers.append(opt)
    return ShardedState(step=state.step, variables=variables,
                        optimizers=optimizers)


def unshard_state(sharded: ShardedState, device=None):
    """The inverse of :func:`shard_state`: a ``learn.train.TrainState``
    with the joined module (:func:`join_params`) and an optimizer of the
    same class and settings holding the joined per-parameter state."""
    from dgpmp2_tpu_torch.learn.train import TrainState

    variables = join_params(sharded.variables, device)
    mp = sharded.variables.mesh.model_parallel
    shards = sharded.variables.shards[:mp]
    order = [n for n, _ in shards[0].named_parameters()]
    states = [_optimizer_state(opt, order)
              for opt in sharded.optimizers[:mp]]
    named = dict(variables.named_parameters())
    opt = _optimizer_like(sharded.optimizers[0],
                          [named[n] for n in order])
    sd = opt.state_dict()
    sd["state"] = {
        i: {key: (_join([s[n][key] for s in states],
                        sharded.variables.specs[n])
                  if isinstance(v, torch.Tensor)
                  and v.shape == shards[0].get_parameter(n).shape else v)
            for key, v in states[0][n].items()}
        for i, n in enumerate(order) if n in states[0]}
    opt.load_state_dict(sd)
    return TrainState(step=sharded.step, variables=variables, optimizer=opt)
