"""dgpmp2_tpu_torch 3-D SDF construction and trilinear lookup against
dgpmp2_tpu, and the 3-D lookup dispatcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu_torch.ops import sdf as tsdf

from _torch_parity import F64, np_, world3d

torch.set_num_threads(1)
LIMS = (-5.0, 5.0)


@pytest.mark.parametrize("chunk_bytes", [tsdf.EDT_CHUNK_BYTES, 4096])
def test_sdf_from_occupancy_3d_matches_jax(chunk_bytes):
    """Exact int32 EDT in three min-plus passes, float64 sqrt: 1e-12.  The
    first volume has no obstacle (the capped transform); a 4 KiB limit
    forces the output-chunked path."""
    vox = world3d(0, 3, 16)[0]
    vox[0] = 1.0
    want = np_(jsdf.sdf_from_occupancy_3d(jnp.asarray(vox), res=10 / 16))
    got = tsdf.sdf_from_occupancy_3d(torch.tensor(vox), res=10 / 16,
                                     dtype=F64, chunk_bytes=chunk_bytes)
    assert got.shape == vox.shape
    np.testing.assert_allclose(np_(got), want, atol=1e-12)
    mask = np.random.default_rng(1).uniform(size=(2, 16, 12, 14)) > 0.9
    mask[0] = False
    sq = tsdf.edt_sq(torch.tensor(mask), spatial_ndim=3,
                     chunk_bytes=chunk_bytes)
    assert sq.dtype == torch.int32
    np.testing.assert_array_equal(
        np_(sq), np_(jsdf.edt_sq(jnp.asarray(mask), spatial_ndim=3)))


def _points3d(rng, b, n_in, n_out):
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (b, n_in, 3)),
                          rng.uniform(-7, 7, (b, n_out, 3))], axis=1)
    # Border points: world corners, faces and voxel edges.
    pts[:, 0] = (-5.0, -5.0, -5.0)
    pts[:, 1] = (5.0, 5.0, 5.0)
    pts[:, 2] = (-5.0, 2.5, 0.3)
    pts[:, 3] = (1.25, 5.0, -5.0)
    pts[:, 4] = (0.3, -0.2, 5.0)
    return pts


@pytest.mark.parametrize("mode", ["intended", "reference"])
def test_trilinear_lookup_matches_jax_f64(mode):
    """Both OOB modes; interior, out-of-bounds, face and corner points:
    1e-12.  lookup_nd on CPU tensors gives the same numbers."""
    n = 16
    rng = np.random.default_rng(2)
    sdf = rng.standard_normal((3, n, n, n))
    pts = _points3d(rng, 3, 30, 10)
    jsdf.set_oob_mode(mode)
    try:
        d_j, g_j = jsdf.trilinear_lookup(jnp.asarray(sdf), jnp.asarray(pts),
                                         10 / n, LIMS, LIMS, LIMS)
    finally:
        jsdf.set_oob_mode("intended")
    d_t, g_t = tsdf.trilinear_lookup(torch.tensor(sdf), torch.tensor(pts),
                                     10 / n, LIMS, LIMS, LIMS, mode)
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-12)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-12)
    tsdf.set_oob_mode(mode)
    try:
        d_l, g_l = tsdf.lookup_nd(torch.tensor(sdf), torch.tensor(pts),
                                  np.float64(10 / n), LIMS, LIMS, LIMS)
    finally:
        tsdf.set_oob_mode("intended")
    np.testing.assert_array_equal(np_(d_l), np_(d_t))
    np.testing.assert_array_equal(np_(g_l), np_(g_t))


def test_trilinear_gradient_matches_jax_autodiff():
    """d and grad differentiate through the plain lookup as through JAX's
    (K-LOOKUP3D's backward replays this): 1e-10."""
    n = 12
    rng = np.random.default_rng(3)
    sdf = rng.standard_normal((2, n, n, n))
    pts = rng.uniform(-4.9, 4.9, (2, 20, 3))
    w_d = rng.standard_normal((2, 20))
    w_g = rng.standard_normal((2, 20, 3))

    def loss_j(s, p):
        d, g = jsdf.trilinear_lookup(s, p, 10 / n, LIMS, LIMS, LIMS)
        return jnp.sum(d * w_d) + jnp.sum(g * w_g)

    gs_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(sdf),
                                                  jnp.asarray(pts))
    s_t = torch.tensor(sdf, requires_grad=True)
    p_t = torch.tensor(pts, requires_grad=True)
    d, g = tsdf.trilinear_lookup(s_t, p_t, 10 / n, LIMS, LIMS, LIMS)
    (torch.sum(d * torch.tensor(w_d)) + torch.sum(g * torch.tensor(w_g))
     ).backward()
    np.testing.assert_allclose(np_(s_t.grad), np_(gs_j), atol=1e-10)
    np.testing.assert_allclose(np_(p_t.grad), np_(gp_j), atol=1e-10)


def test_plain_trilinear_f32_matches_pallas_interpret():
    """T6, the TPU tiled kernel, in interpret mode (16^3, one 16^3 brick,
    B=2, P=24; random trajectory-shaped points plus OOB ones): d within
    2e-5, gradient within 1e-4, the JAX test's own bounds."""
    from dgpmp2_tpu.ops.pallas.sdf_lookup3d import trilinear_lookup_pallas

    n = 16
    rng = np.random.default_rng(4)
    sdf = rng.standard_normal((2, n, n, n)).astype(np.float32)
    t = np.linspace(0, 1, 20)[None, :, None]
    s, g = rng.uniform(-4.5, -3.5, (2, 1, 3)), rng.uniform(3.5, 4.5, (2, 1, 3))
    pts = np.concatenate([s + t * (g - s) + 0.1 * rng.standard_normal(
        (2, 20, 3)), rng.uniform(-7, 7, (2, 4, 3))], axis=1).astype(np.float32)
    d_j, g_j = trilinear_lookup_pallas(jnp.asarray(sdf), jnp.asarray(pts),
                                       10 / n, LIMS, LIMS, LIMS, bz=16,
                                       by=16, interpret=True)
    d_t, g_t = tsdf.trilinear_lookup(torch.tensor(sdf), torch.tensor(pts),
                                     10 / n, LIMS, LIMS, LIMS)
    assert d_t.dtype == torch.float32
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=2e-5)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-4)


def test_lookup3d_method_dispatch_and_refusals():
    sdf = torch.tensor(np.random.default_rng(5).standard_normal((1, 8, 8, 8)))
    pts = torch.tensor([[[0.1, -0.2, 0.3], [9.0, 0.0, 0.0]]], dtype=F64)
    want = tsdf.trilinear_lookup(sdf, pts, 10 / 8, LIMS, LIMS, LIMS)
    with pytest.raises(ValueError):
        tsdf.set_lookup3d_method("bogus")
    try:
        for method in tsdf.LOOKUP3D_ENGINES:
            tsdf.set_lookup3d_method(method)
            got = tsdf.lookup_nd(sdf, pts, 10 / 8, LIMS, LIMS, LIMS)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np_(a), np_(b))
        tsdf.set_oob_mode("reference")
        with pytest.raises(NotImplementedError, match="intended"):
            tsdf.lookup_nd(sdf, pts, 10 / 8, LIMS, LIMS, LIMS)
        tsdf.set_lookup3d_method("gather")
        tsdf.lookup_nd(sdf, pts, 10 / 8, LIMS, LIMS, LIMS)
    finally:
        tsdf.set_oob_mode("intended")
        tsdf.set_lookup3d_method("auto")
    for fn in (tsdf.lookup_nd, tsdf.trilinear_lookup):
        with pytest.raises(NotImplementedError, match="asymmetric"):
            fn(sdf, pts, 10 / 8, LIMS, (-4.0, 6.0), LIMS)
