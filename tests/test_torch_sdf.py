"""dgpmp2_tpu_torch SDF construction and lookup against dgpmp2_tpu."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu_torch.ops import sdf as tsdf

from _torch_parity import F64, np_

torch.set_num_threads(1)
LIMS = (-5.0, 5.0)


@pytest.mark.parametrize("chunk_bytes", [tsdf.EDT_CHUNK_BYTES, 4096])
def test_sdf_from_occupancy_matches_jax(chunk_bytes):
    """Exact int32 EDT, float64 sqrt: 1e-12.  A 4 KiB limit forces the
    output-chunked min-plus path."""
    rng = np.random.default_rng(0)
    img = (rng.uniform(size=(3, 24, 24)) > 0.2).astype(np.float64)
    img[0] = 1.0  # no obstacle at all: the capped transform
    want = np_(jsdf.sdf_from_occupancy(jnp.asarray(img), res=10 / 24))
    got = tsdf.sdf_from_occupancy(torch.tensor(img), res=10 / 24, dtype=F64,
                                  chunk_bytes=chunk_bytes)
    np.testing.assert_allclose(np_(got), want, atol=1e-12)
    sq = tsdf.edt_sq(torch.tensor(img > 0.5), chunk_bytes=chunk_bytes)
    assert sq.dtype == torch.int32
    np.testing.assert_array_equal(np_(sq),
                                  np_(jsdf.edt_sq(jnp.asarray(img > 0.5))))


def _points(rng, b, n_in, n_out):
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (b, n_in, 2)),
                          rng.uniform(-7, 7, (b, n_out, 2))], axis=1)
    # Border points: exactly on the world limits and on pixel edges.
    pts[:, 0] = (-5.0, -5.0)
    pts[:, 1] = (5.0, 5.0)
    pts[:, 2] = (-5.0, 2.5)
    pts[:, 3] = (1.25, 5.0)
    return pts


@pytest.mark.parametrize("mode", ["intended", "reference"])
def test_bilinear_lookup_matches_jax_f64(mode):
    """Both OOB modes, interior, out-of-bounds and border points: 1e-12."""
    n = 64
    rng = np.random.default_rng(1)
    sdf = rng.standard_normal((3, n, n))
    pts = _points(rng, 3, 40, 10)
    jsdf.set_oob_mode(mode)
    try:
        d_j, g_j = jsdf.bilinear_lookup(jnp.asarray(sdf), jnp.asarray(pts),
                                        10 / n, LIMS, LIMS)
    finally:
        jsdf.set_oob_mode("intended")
    d_t, g_t = tsdf.bilinear_lookup(torch.tensor(sdf), torch.tensor(pts),
                                    10 / n, LIMS, LIMS, mode)
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-12)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-12)
    tsdf.set_oob_mode(mode)
    try:
        d_l, g_l = tsdf.lookup(torch.tensor(sdf), torch.tensor(pts),
                               np.float64(10 / n), LIMS, LIMS)
    finally:
        tsdf.set_oob_mode("intended")
    np.testing.assert_array_equal(np_(d_l), np_(d_t))
    np.testing.assert_array_equal(np_(g_l), np_(g_t))


def test_plain_lookup_f32_matches_pallas_v2_interpret():
    """The TPU default kernel in interpret mode, as tests/test_sdf.py runs
    it: d within 1e-4, gradient within 1e-3 (float32, x·(1/res) there)."""
    from dgpmp2_tpu.ops.pallas.sdf_lookup import bilinear_lookup_pallas_v2

    n = 64
    rng = np.random.default_rng(15)
    sdf = rng.standard_normal((3, n, n)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (3, 40, 2)),
                          rng.uniform(-7, 7, (3, 10, 2))],
                         axis=1).astype(np.float32)
    d_j, g_j = bilinear_lookup_pallas_v2(jnp.asarray(sdf), jnp.asarray(pts),
                                         10 / n, LIMS, LIMS, 2, True)
    d_t, g_t = tsdf.bilinear_lookup(torch.tensor(sdf), torch.tensor(pts),
                                    10 / n, LIMS, LIMS)
    assert d_t.dtype == torch.float32
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-4)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-3)


def test_lookup_refuses_asymmetric_y_lims():
    sdf = torch.zeros((1, 8, 8), dtype=F64)
    pts = torch.zeros((1, 3, 2), dtype=F64)
    with pytest.raises(NotImplementedError, match="asymmetric"):
        tsdf.lookup(sdf, pts, 10 / 8, LIMS, (-4.0, 6.0))
    with pytest.raises(ValueError):
        tsdf.set_oob_mode("clamp")


def test_lookup_gradient_matches_jax_autodiff():
    """d and grad differentiate through the plain lookup as through JAX's
    gather lookup (the kernel's backward replays this): 1e-10."""
    import jax

    n = 32
    rng = np.random.default_rng(3)
    sdf = rng.standard_normal((2, n, n))
    pts = rng.uniform(-4.9, 4.9, (2, 20, 2))
    w_d = rng.standard_normal((2, 20))
    w_g = rng.standard_normal((2, 20, 2))

    def loss_j(s, p):
        d, g = jsdf.bilinear_lookup(s, p, 10 / n, LIMS, LIMS)
        return jnp.sum(d * w_d) + jnp.sum(g * w_g)

    gs_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(sdf),
                                                  jnp.asarray(pts))
    s_t = torch.tensor(sdf, requires_grad=True)
    p_t = torch.tensor(pts, requires_grad=True)
    d, g = tsdf.bilinear_lookup(s_t, p_t, 10 / n, LIMS, LIMS)
    (torch.sum(d * torch.tensor(w_d)) + torch.sum(g * torch.tensor(w_g))
     ).backward()
    np.testing.assert_allclose(np_(s_t.grad), np_(gs_j), atol=1e-10)
    np.testing.assert_allclose(np_(p_t.grad), np_(gp_j), atol=1e-10)
