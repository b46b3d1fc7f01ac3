"""The dense oracle of dgpmp2_tpu_torch (``core.dense``,
``ops.tridiag.btd_to_dense``) against dgpmp2_tpu's, and the port's block
assembly against its own oracle.

Float64 on the CPU, T=12 (T=16 for the bench problem), 32x32 worlds; the
problems of ``test_torch_constraints.py`` (every factor family the JAX
oracle tests cover: ``tests/test_graph.py:86-254`` with GP interpolation,
``test_arm.py:62,194``, ``test_jointlimits.py:65``,
``test_selfcollision.py:97``, ``test_workspace_goal.py:60``) and the
bench problem.  ``(A, b, K)`` and ``solve_dense`` agree with JAX's to
1e-12; ``btd_to_dense(assemble_from_residuals(...))`` equals the port's
``AᵀKA`` and ``rhs`` its ``AᵀKb`` to 1e-12 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import dense as jdense
from dgpmp2_tpu.ops import tridiag as jtridiag
from dgpmp2_tpu_torch.core import dense as tdense
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.ops import tridiag as ttridiag

from _torch_parity import both_problems, np_
from test_torch_constraints import CASES, build

torch.set_num_threads(1)
TOL = 1e-12
J_DENSE = jax.jit(jdense.assemble_dense, static_argnums=(0, 1))
# The dense oracle is 2-D only (an (H, W) SDF, no z_lims), as JAX's.
DENSE_CASES = sorted(c for c in CASES if "z_lims" not in CASES[c][1])
# Each JAX oracle compiles for seconds: against JAX, each family once (the
# arm cases carry self-collision and joint limits, "all" every factor
# together with GP interpolation on an arm); the port against its own
# oracle on every case.
JAX_CASES = ("bench", "non_holonomic", "vel_limits", "gp_inter", "arm_yaml",
             "arm3_task", "all")


def problem_rows(pj, pt, i):
    """Problem ``i`` of a batched pair, unbatched: (spec, robot, params, th,
    sdf) for JAX, then torch."""
    out = []
    for spec, robot, params, th, sdf in (pj, pt):
        one = {f.name: None if getattr(params, f.name) is None
               else getattr(params, f.name)[i]
               for f in dataclasses.fields(params)}
        out.append((spec, robot, dataclasses.replace(params, **one), th[i],
                    sdf[i]))
    return out


def close(got, want, tol=TOL, msg=""):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


@functools.lru_cache(maxsize=None)
def pair(case):
    if case == "bench":
        return both_problems(seed=3, b=2, t=16)
    return build(case)


@pytest.mark.parametrize("case", JAX_CASES)
def test_dense_system_matches_jax(case):
    pj, pt = pair(case)
    for i in range(pt[3].shape[0]):
        one_j, one_t = problem_rows(pj, pt, i)
        got = tdense.assemble_dense(*one_t)
        want = J_DENSE(*one_j)
        assert got[0].shape == (pt[0].M, pt[0].N)
        for name, a, b in zip("AbK", got, want):
            close(a, b, msg=name)
        close(tdense.solve_dense(*got, 0.1),
              jdense.solve_dense(*want, 0.1), msg="solve_dense")
        # b is the stacked residual vector of the batched graph functions.
        close(got[1], tg.linear_error(*pt)[i], msg="linear_error")


@pytest.mark.parametrize("case", ["bench"] + DENSE_CASES)
def test_block_assembly_matches_the_port_oracle(case):
    """``blocktridiag(assemble) == AᵀKA`` and ``rhs == AᵀKb``; the damped
    block solve equals ``solve_dense``; the weighted error is ½bᵀKb/M."""
    _, pt = pair(case)
    spec, robot, params, th, sdf = pt
    res = tg.eval_residuals(*pt)
    diag, off, rhs = tg.assemble_from_residuals(spec, params, res)
    dth = tgn.gn_step(spec, robot, params, th, sdf, 0.1)
    err = tg.error_from_residuals(spec, params, res)
    for i in range(th.shape[0]):
        A, b, K = tdense.assemble_dense(*problem_rows(pt, pt, i)[1])
        atk = A.T @ K
        close(ttridiag.btd_to_dense(diag[i], off[i]), atk @ A, msg="AᵀKA")
        close(rhs[i].reshape(-1), atk @ b, msg="AᵀKb")
        close(dth[i].reshape(-1), tdense.solve_dense(A, b, K, 0.1),
              tol=1e-10, msg="solve")
        close(err[i], 0.5 * (b @ K @ b) / spec.M, msg="error")


def test_btd_to_dense_matches_jax():
    rng = np.random.default_rng(4)
    for t, d in ((1, 3), (2, 1), (5, 4)):
        diag = rng.standard_normal((2, t, d, d))
        off = rng.standard_normal((2, max(t - 1, 0), d, d))
        got = ttridiag.btd_to_dense(torch.tensor(diag), torch.tensor(off))
        want = jtridiag.btd_to_dense(jnp.asarray(diag), jnp.asarray(off))
        assert got.shape == (2, t * d, t * d)
        np.testing.assert_array_equal(np_(got), np_(want))


def test_oracle_refuses_3d_and_fills_every_row():
    (_, pt) = build("vel_limits_3d")
    with pytest.raises(ValueError, match="2-D only"):
        tdense.assemble_dense(*problem_rows(pt, pt, 0)[1])
