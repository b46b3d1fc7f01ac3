"""dgpmp2_tpu_torch.parallel.sharding against dgpmp2_tpu.parallel.sharding
on the CPU: meshes (shapes, the warning fallback, ``strict``), the
multi-host mesh, batch specs, ``shard_batch`` then ``gather_batch`` as the
identity, ``param_spec`` on the same parameters of the learned head as
JAX's, and ``shard_params`` / ``shard_state`` (slices of the split
parameters, replicas of the rest).  The service on a mesh is in
``tests/test_torch_serve.py``, the mesh's execution in
``tests/test_torch_parallel.py``."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dgpmp2_tpu.parallel import sharding as jsh
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.learn import train as ttrain
from dgpmp2_tpu_torch.parallel import sharding as tsh

from _torch_parity import BOUNDED, both_problems, learned_pair

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("n,mp", [(8, 1), (8, 2), (8, 4), (4, 2)])
def test_make_mesh_matches_jax(n, mp):
    mesh = tsh.make_mesh(CPU8[:n], model_parallel=mp)
    want = jsh.make_mesh(jax.devices()[:n], model_parallel=mp)
    assert mesh.shape == dict(want.shape)
    assert mesh.axis_names == tuple(want.axis_names)
    assert mesh.size == want.devices.size == n
    assert len(mesh.data_devices()) == n // mp


def test_make_mesh_warns_and_falls_back_or_raises_under_strict():
    with pytest.warns(UserWarning, match="falling back to model_parallel=1"):
        mesh = tsh.make_mesh(CPU8[:6], model_parallel=4)
    assert mesh.shape == {"data": 6, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        tsh.make_mesh(CPU8[:6], model_parallel=4, strict=True)
    with pytest.raises(ValueError, match="at least one device"):
        tsh.make_mesh([])


def test_multihost_mesh_and_shardings_match_jax():
    mesh = tsh.make_multihost_mesh(2, devices=CPU8)
    want = jsh.make_multihost_mesh(2)
    assert mesh.shape == dict(want.shape)
    assert mesh.axis_names == tuple(want.axis_names)
    assert len(mesh.data_devices()) == 4
    for m, w in ((mesh, want), (tsh.make_mesh(CPU8), jsh.make_mesh(
            jax.devices()[:8]))):
        assert tuple(tsh.batch_sharding(m).spec) == tuple(
            jsh.batch_sharding(w).spec)
        assert tuple(tsh.replicated(m).spec) == tuple(jsh.replicated(w).spec)


def test_shard_batch_then_gather_is_the_identity():
    """A GraphParams pytree (None fields kept) with tensors in a dict and a
    tuple, over 8 shards and over a (4, 2) mesh's 4 data rows."""
    (_, pt) = both_problems(seed=2, b=8, t=6)
    spec, robot, params, th, sdf = pt
    batch = {"params": params, "x": (th, sdf), "n": 3}
    for mesh, n in ((tsh.make_mesh(CPU8), 8),
                    (tsh.make_mesh(CPU8, model_parallel=2), 4)):
        shards = tsh.shard_batch(batch, mesh)
        assert len(shards) == n
        assert shards[1]["x"][0].shape == (8 // n, *th.shape[1:])
        assert shards[0]["params"].dyn_inv is None and shards[0]["n"] == 3
        back = tsh.gather_batch(shards)
        for f in dataclasses.fields(params):
            a, b = getattr(back["params"], f.name), getattr(params, f.name)
            assert (a is None and b is None) or torch.equal(a, b), f.name
        assert torch.equal(back["x"][0], th) and torch.equal(back["x"][1],
                                                             sdf)
    with pytest.raises(ValueError, match="not divisible by 8"):
        tsh.shard_batch(th[:6], tsh.make_mesh(CPU8))


def flax_names(variables):
    """The port's parameter name -> its flax path string (as JAX's
    ``shard_params`` names it), by filling each parameter with its index
    and reading where it lands in ``convert.learned_state_to_flax``."""
    marked = copy.deepcopy(variables)
    names = list(marked.state_dict())
    with torch.no_grad():
        for i, k in enumerate(names):
            marked.state_dict(keep_vars=True)[k].fill_(float(i))
    tree = convert.learned_state_to_flax(marked)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {names[int(np.asarray(leaf).flat[0])]:
            ("/".join(str(p) for p in path), np.shape(leaf))
            for path, leaf in flat}


def test_param_spec_matches_jax_on_the_learned_head():
    """Each parameter's spec is JAX's for its flax path, reversed for a
    Dense kernel (a Linear weight is its (out, in) transpose); the wide
    head's first two layers and bias are the ones split."""
    _, (_, variables, *_), _ = learned_pair(BOUNDED, b=2, t=8)
    split = []
    for name, (path, shape) in flax_names(variables).items():
        want = tuple(jsh.param_spec(path, shape))
        want += (None,) * (len(shape) - len(want))
        if path.endswith("['kernel']") and len(shape) == 2:
            want = want[::-1]
        got = tuple(tsh.param_spec(name, variables.state_dict()[name].shape))
        got += (None,) * (len(shape) - len(got))
        assert got == want, (name, path)
        if any(got):
            split.append(name)
    assert sorted(split) == ["head.dense.0.bias", "head.dense.0.weight",
                             "head.dense.1.weight"]


def test_shard_params_and_state_place_every_parameter_on_every_device():
    """Every device holds a shard of every parameter: its model slice of
    the split ones (rows of ``head.dense.0``, columns of ``head.dense.1``),
    a full replica of the rest; the optimizer's state is split as its
    parameter."""
    _, (planner, variables, _, th, sdf, im), _ = learned_pair(BOUNDED, b=2,
                                                              t=8)
    mesh = tsh.make_mesh(CPU8, model_parallel=2)
    sp = tsh.shard_params(variables, mesh)
    assert len(sp.shards) == 8
    for k in range(8):
        named = sp.named(k)
        assert set(named) == set(variables.state_dict())
        for name, v in variables.state_dict().items():
            dim = {tsh.P("model", None): 0, tsh.P(None, "model"): 1,
                   tsh.P("model"): 0}.get(sp.specs[name])
            want = v if dim is None else v.chunk(2, dim)[k % 2]
            assert torch.equal(named[name], want), (k, name)
    assert sp.specs["head.dense.1.weight"] == tsh.P(None, "model")
    assert sp.named(3)["head.dense.1.weight"].shape == (640, 500)
    state = ttrain.init_train_state(
        planner, ttrain.make_optimizer("adam", {"alpha": 1e-3}),
        torch.Generator().manual_seed(0), planner.stack_inputs(im, sdf), th)
    for p in state.variables.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    sh = tsh.shard_state(state, mesh)
    assert sh.step == state.step
    assert sh.opt_state.specs["head.dense.0.weight.exp_avg"] == tsh.P(
        "model", None)
    assert len(sh.opt_state.shards[7]) == 3 * len(
        list(state.variables.parameters()))
    assert sh.opt_state.named(7)["head.dense.0.weight.exp_avg"].shape == (
        500, state.variables["head"].dense[0].in_features)
