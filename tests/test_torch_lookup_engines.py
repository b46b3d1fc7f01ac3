"""dgpmp2_tpu_torch 2-D lookup engines against dgpmp2_tpu: the "pallas"
engine (TPU kernel T4), the bf16 limb engines "pallas_v3*" (T5) and the
engine switch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.ops.pallas import sdf_lookup as jpallas
from dgpmp2_tpu_torch.ops import sdf as tsdf

from _torch_parity import F64, np_

torch.set_num_threads(1)
LIMS = (-5.0, 5.0)
N = 64


def _inputs(seed, b=4, n_in=40, n_out=10):
    """float32 SDF (b, N, N) and random points (pixel-edge points are left
    out: the TPU kernels form x·(1/res), the port divides)."""
    rng = np.random.default_rng(seed)
    sdf = rng.standard_normal((b, N, N)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (b, n_in, 2)),
                          rng.uniform(-7, 7, (b, n_out, 2))],
                         axis=1).astype(np.float32)
    return sdf, pts


def test_plain_lookup_f32_matches_pallas_v1_interpret():
    """T4 (the "pallas" engine) in interpret mode: d within 1e-4, gradient
    within 1e-3."""
    sdf, pts = _inputs(10)
    d_j, g_j = jpallas.bilinear_lookup_pallas(jnp.asarray(sdf),
                                              jnp.asarray(pts), 10 / N, LIMS,
                                              LIMS, 2, True)
    d_t, g_t = tsdf.bilinear_lookup(torch.tensor(sdf), torch.tensor(pts),
                                    10 / N, LIMS, LIMS)
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-4)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-3)


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_limb_split_is_bit_equal_to_jax(n_limbs):
    """Round-to-nearest-even float32 -> bf16 in both frameworks; compared as
    float32 values, bit for bit."""
    sdf = _inputs(11)[0] * 3.0
    sdf[0, 0, :4] = (0.0, -0.0, 1e-30, 3.0e38)
    got = tsdf.limb_split(torch.tensor(sdf), n_limbs)
    want = jpallas._limb_split(jnp.asarray(sdf), n_limbs)
    assert got.dtype == torch.bfloat16 and got.shape == (4, n_limbs, N, N)
    np.testing.assert_array_equal(
        np_(got.to(torch.float32)).view(np.uint32),
        np.asarray(want.astype(jnp.float32)).view(np.uint32))


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_limb_lookup_matches_pallas_v3_interpret(n_limbs):
    """T5 in interpret mode: both read the same limbs, so only float32
    blend rounding differs: d within 1e-4, gradient within 1e-3."""
    sdf, pts = _inputs(12)
    d_j, g_j = jpallas.bilinear_lookup_pallas_v3(
        jnp.asarray(sdf), jnp.asarray(pts), 10 / N, LIMS, LIMS, 2, n_limbs,
        True)
    limbs = tsdf.limb_split(torch.tensor(sdf), n_limbs)
    d_t, g_t = tsdf.bilinear_lookup_limbs(limbs, torch.tensor(pts), 10 / N,
                                          LIMS, LIMS)
    assert d_t.dtype == g_t.dtype == torch.float32
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-4)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-3)


@pytest.mark.parametrize("method,n_limbs", sorted(tsdf.LIMB_ENGINES.items()))
def test_limb_engine_backward_replays_the_exact_lookup(method, n_limbs):
    """The limb engine's forward reads the limbs; its backward is the exact
    lookup's on the unsplit SDF (as the TPU kernel's _mxu_replay_bwd), here
    float64 on the SDF the limbs reconstruct: 1e-10."""
    sdf, pts = _inputs(13, b=2, n_in=20, n_out=4)
    rng = np.random.default_rng(14)
    limbs = tsdf.limb_split(torch.tensor(sdf), n_limbs)
    recon = limbs.to(F64).sum(dim=1).numpy()
    # Cotangents exact in float32, so the float32 outputs pass them on as is.
    w_d = rng.standard_normal((2, 24)).astype(np.float32).astype(np.float64)
    w_g = rng.standard_normal((2, 24, 2)).astype(np.float32).astype(np.float64)
    grads = []
    for engine in (method, "gather"):
        s = torch.tensor(recon, requires_grad=True)
        p = torch.tensor(pts.astype(np.float64), requires_grad=True)
        tsdf.set_lookup_method(engine)
        try:
            d, g = tsdf.lookup(s, p, 10 / N, LIMS, LIMS)
        finally:
            tsdf.set_lookup_method("auto")
        assert d.dtype == (torch.float32 if engine == method else F64)
        (torch.sum(d * torch.tensor(w_d)) + torch.sum(g * torch.tensor(w_g))
         ).backward()
        grads.append((s.grad, p.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-10)


def test_lookup_method_dispatch_and_refusals():
    sdf, pts = (torch.tensor(a) for a in _inputs(15, b=2))
    exact = tsdf.bilinear_lookup(sdf, pts, 10 / N, LIMS, LIMS)
    try:
        for method in tsdf.EXACT_ENGINES:
            tsdf.set_lookup_method(method)
            for a, b in zip(tsdf.lookup(sdf, pts, 10 / N, LIMS, LIMS), exact):
                np.testing.assert_array_equal(np_(a), np_(b))
        for method, n_limbs in tsdf.LIMB_ENGINES.items():
            tsdf.set_lookup_method(method)
            got = tsdf.lookup(sdf, pts, 10 / N, LIMS, LIMS)
            want = tsdf.bilinear_lookup_limbs(tsdf.limb_split(sdf, n_limbs),
                                              pts, 10 / N, LIMS, LIMS)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np_(a), np_(b))
            tsdf.set_oob_mode("reference")
            try:
                with pytest.raises(NotImplementedError, match="intended"):
                    tsdf.lookup(sdf, pts, 10 / N, LIMS, LIMS)
            finally:
                tsdf.set_oob_mode("intended")
        for method in ("mxu", "rows"):
            with pytest.raises(NotImplementedError, match="Not to port"):
                tsdf.set_lookup_method(method)
        with pytest.raises(ValueError):
            tsdf.set_lookup_method("bogus")
        assert tsdf._LOOKUP_METHOD == "pallas_v3_1"
        with pytest.raises(NotImplementedError, match="asymmetric"):
            tsdf.lookup(sdf, pts, 10 / N, LIMS, (-4.0, 6.0))
    finally:
        tsdf.set_lookup_method("auto")
