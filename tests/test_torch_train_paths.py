"""One training step of dgpmp2_tpu_torch.learn.train against the JAX
package's, on every path of ``make_train_step``: the same float64 problem,
weights (``convert.seeded_flax_tree``) and fresh optimizer state in both
packages; the loss, the metrics and every updated weight compared leaf
against leaf.

Tolerances.  Both packages decode the head's output in float32.  The
jitted JAX train step and the eager torch one round that float32 decode
differently (the loss parts at ~1e-8 relative, and the weight updates at
~1e-5, even at one GN step, where each package's eager step agrees with the
other to 1e-14), so the paths are compared with the decode in float64 on
both sides: the JAX package's ``jnp.float32`` patched to float64 in its
``learn.train`` (where it also fixes the seed trajectory's and the fixed
covariances' dtype) and ``learn.learned_planner`` modules, the port's
``predict`` through ``chip_smoke.decode_in_float64``.  Then the loss agrees
to 1e-10 relative (5e-15 seen) and each weight's update to 1e-9 relative to
its largest entry (1.4e-10 seen under Adam, 5e-12 under SGD).  One case
keeps the shipped float32 decode: loss 1e-6 (6e-8 seen), updates 1e-4
(7e-6 seen).  Dropout is 0 (jax.random masks cannot be drawn in torch; the
port's masks are tested in test_torch_train.py).
"""
import jax
import pytest
import torch

from _torch_parity import BOUNDED, check_train_step, train_pair

torch.set_num_threads(1)


PATHS = {
    "chunked tk=T": (BOUNDED, dict(T=2, tk=2, remat=False), "gauss_newton"),
    "chunked tk<T": (BOUNDED, dict(T=2, tk=1), "gauss_newton"),
    "lm": (BOUNDED, dict(T=2, tk=1), "lm"),
    "sliding tk2>tk": (BOUNDED, dict(T=2, tk=1, tk2=2), "gauss_newton"),
    "optimize_tk": (BOUNDED, dict(T=2, tk=1, optimize_tk=True),
                    "gauss_newton"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_train_step_matches_jax(path, monkeypatch):
    lkw, cfg, method = PATHS[path]
    out = train_pair(lkw, cfg, method, monkeypatch=monkeypatch)
    moved = check_train_step(*out, tol_loss=1e-10, tol_update=1e-9)
    assert moved == len(jax.tree.leaves(out[2]))
