"""dgpmp2_tpu_torch block-tridiagonal solve against dgpmp2_tpu.

The port's plain ``btd_solve`` is the oracle of the K-BTD CUDA kernel; here
it is held against the JAX solve in float64 and against the two TPU kernels
(run in Pallas interpret mode) in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.ops import tridiag as jt
from dgpmp2_tpu_torch.ops import tridiag as tt
from dgpmp2_tpu_torch.ops.cuda import btd_solve as k_btd

from _torch_parity import F64, np_

torch.set_num_threads(1)


def spd_system(seed, b=3, t=12, d=4):
    """Block-diagonally dominant SPD system (numpy float64); above D = 16
    the off blocks shrink as D^-½, as in chip_smoke.spd_system."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, t, d, d))
    diag = g @ np.swapaxes(g, -1, -2) * 0.1 + 4.0 * np.eye(d)
    off = 0.3 * min(1.0, (16 / d) ** 0.5) * rng.standard_normal(
        (b, t - 1, d, d))
    rhs = rng.standard_normal((b, t, d))
    return diag, off, rhs


@pytest.mark.parametrize("d", [2, 3, 4, 6, 8, 10, 16, 18, 32])
def test_btd_solve_matches_jax_f64(d):
    diag, off, rhs = spd_system(0, d=d)
    x_t = tt.btd_solve(*(torch.tensor(a) for a in (diag, off, rhs)))
    x_j = jt.btd_solve(*(jnp.asarray(a) for a in (diag, off, rhs)))
    np.testing.assert_allclose(np_(x_t), np_(x_j), rtol=1e-10, atol=1e-10)
    res = tt.btd_matvec(torch.tensor(diag), torch.tensor(off), x_t)
    np.testing.assert_allclose(np_(res), rhs, atol=1e-10)


def _rel(a, b):
    return np.abs(np_(a) - np_(b)).max() / np.abs(np_(b)).max()


def test_btd_solve_f32_matches_pallas_interpret():
    """Both TPU solve kernels in interpret mode, B=8, T=20: 1e-4 relative."""
    from dgpmp2_tpu.ops.pallas.btd_solve import btd_solve_pallas
    from dgpmp2_tpu.ops.pallas.btd_stream import btd_solve_stream

    sys32 = [a.astype(np.float32) for a in spd_system(1, b=8, t=20)]
    x_t = tt.btd_solve(*(torch.tensor(a) for a in sys32))
    assert x_t.dtype == torch.float32
    args = [jnp.asarray(a) for a in sys32]
    assert _rel(x_t, btd_solve_pallas(*args, interpret=True)) < 1e-4
    assert _rel(x_t, btd_solve_stream(*args, interpret=True, chunk=4)) < 1e-4


@pytest.mark.parametrize("d", [2, 3, 4, 6, 8, 10, 16, 18, 32])
def test_btd_solve_vjp_matches_jax_f64(d):
    """The implicit adjoint (diag, off and rhs cotangents): 1e-9."""
    diag, off, rhs = spd_system(2, d=d)
    xbar = np.random.default_rng(3).standard_normal(rhs.shape)
    x_j, vjp = jax.vjp(jt.btd_solve, *(jnp.asarray(a) for a in (diag, off,
                                                                   rhs)))
    want = vjp(jnp.asarray(xbar))
    ins = [torch.tensor(a, requires_grad=True) for a in (diag, off, rhs)]
    x_t = tt.btd_solve(*ins)
    x_t.backward(torch.tensor(xbar))
    for got, ref in zip(ins, want):
        np.testing.assert_allclose(np_(got.grad), np_(ref), atol=1e-9)


def test_btd_solve_gives_nan_on_a_non_pd_block_as_jax():
    """A diag block that is not positive definite in one problem: NaN in
    that problem where JAX's Cholesky gives NaN, not an error, and the
    batch's other problems solved as JAX solves them (1e-10)."""
    diag, off, rhs = spd_system(6)
    diag[1, 5] = -diag[1, 5]
    x_t = np_(tt.btd_solve(*(torch.tensor(a) for a in (diag, off, rhs))))
    x_j = np_(jt.btd_solve(*(jnp.asarray(a) for a in (diag, off, rhs))))
    assert np.isnan(x_t[1]).any()
    np.testing.assert_array_equal(np.isnan(x_t), np.isnan(x_j))
    assert np.isfinite(x_t[[0, 2]]).all()
    np.testing.assert_allclose(x_t[[0, 2]], x_j[[0, 2]], rtol=1e-10,
                               atol=1e-10)


def test_btd_solve_auto_on_cpu_is_the_plain_solve():
    """CPU tensors take the plain version; the kernel is not launched."""
    before = k_btd.launches
    sys_ = [torch.tensor(a) for a in spd_system(4)]
    np.testing.assert_array_equal(np_(tt.btd_solve_auto(*sys_)),
                                  np_(tt.btd_solve(*sys_)))
    assert k_btd.launches == before == 0


def test_btd_factor_single_step():
    """T = 1 is a plain Cholesky solve (no off-diagonal blocks)."""
    diag, off, rhs = spd_system(5, t=1)
    x = tt.btd_solve(torch.tensor(diag), torch.tensor(off), torch.tensor(rhs))
    np.testing.assert_allclose(np_(x)[:, 0], np.linalg.solve(
        diag[:, 0], rhs[:, 0][..., None])[..., 0], atol=1e-12)
    assert x.dtype == F64
