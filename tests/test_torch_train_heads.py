"""One training step of dgpmp2_tpu_torch.learn.train against the JAX
package's, for what the planner and optimizer add to the paths of
test_torch_train_paths.py: ``fixed_conv`` under AdamW, the GRU head, the 3-D
planner and the shipped float32 decode.  Tolerances and the float64 decode
as test_torch_train_paths.py states them.
"""
import jax
import pytest
import torch

from _torch_parity import BOUNDED, check_train_step, train_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("opt", [("sgd", {"alpha": 0.01}),
                                 ("adam", {"alpha": 1e-3,
                                           "reg_strength": 0.01})],
                         ids=["sgd", "adamw"])
def test_fixed_conv_train_step_matches_jax(opt, monkeypatch):
    """The encoder's leaves get zero gradients but stay in the norm and the
    optimizer: under SGD they do not move, under AdamW they decay, as in
    optax."""
    out = train_pair(dict(BOUNDED, fixed_conv=True), dict(T=2, tk=1),
                     opt=opt, monkeypatch=monkeypatch)
    moved = check_train_step(*out, tol_loss=1e-10, tol_update=1e-9)
    total = len(jax.tree.leaves(out[2]))
    conv = len(jax.tree.leaves(out[2]["conv"]))
    assert moved == (total if opt[0] == "adam" else total - conv)


def test_gru_train_step_matches_jax(monkeypatch):
    out = train_pair(dict(model_type="rnn_gru", hidden_dim=8, learn_eps=True,
                          static_init=(1.0, 0.05, 0.4)), dict(T=2, tk=1),
                     monkeypatch=monkeypatch)
    check_train_step(*out, tol_loss=1e-10, tol_update=1e-9)


def test_train_step_3d_matches_jax(monkeypatch):
    """The 3-D planner (ConvEncoder3D, 16^3 voxels, PointRobot3D), as
    tests/test_learn3d.py:75 trains it."""
    out = train_pair(dict(dynamics_mode="diag_identity", learn_eps=True,
                          static_init=(1.0, 0.05, 0.4), dropout_prob=0.0),
                     dict(T=2, tk=1), three_d=True, monkeypatch=monkeypatch,
                     b=2)
    check_train_step(*out, tol_loss=1e-10, tol_update=1e-9)


def test_train_step_with_the_shipped_float32_decode(monkeypatch):
    out = train_pair(BOUNDED, dict(T=2, tk=1), decode64=False,
                     monkeypatch=monkeypatch)
    check_train_step(*out, tol_loss=1e-6, tol_update=1e-4)
