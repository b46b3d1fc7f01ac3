"""dgpmp2_tpu_torch.native against dgpmp2_tpu.native: the same C++ source
(csrc/dgpmp2_native.cpp) built by each package into its own library.

The port's library is built here with g++ into dgpmp2_tpu_torch/build/ and
has no fallback.  Exact equality of the EDT, the SDF and RRT* paths; RRT*
runs to a time budget, so the paths are compared with ``max_iters``
binding long before ``plan_time``.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from dgpmp2_tpu import native as jnative
from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.ops import sdf as tsdf

LIMS = (-5.0, 5.0)


def masks(seed, shapes=((96, 64), (32, 32), (1, 7), (128, 128))):
    rng = np.random.default_rng(seed)
    return [rng.random(s) < p for s, p in zip(shapes, (0.08, 0.3, 0.5, 0.02))]


def block_world(n=96):
    img = np.ones((n, n))
    img[n // 3:2 * n // 3 + 2, n // 3:2 * n // 3 + 2] = 0.0
    return img


def test_the_library_builds_with_gxx_into_the_port_build_dir():
    lib = native.load()
    path = native.library_path()
    assert path.is_file() and lib is native.load()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "dgpmp2_tpu_torch"
    assert path.name.startswith("libdgpmp2_native_")
    assert native.available()


def test_edt_sq_equals_the_jax_package_native():
    for m in masks(0):
        np.testing.assert_array_equal(native.edt_sq(m), jnative.edt_sq(m))


def test_sdf_2d_equals_the_jax_package_native():
    for i, m in enumerate(masks(1)):
        res = 10.0 / m.shape[1]
        got = native.sdf_2d(~m, res)
        assert got.dtype == np.float32 and got.shape == m.shape
        np.testing.assert_array_equal(got, jnative.sdf_2d(~m, res))


@pytest.mark.parametrize("n", [32, 64, 128])
def test_sdf_2d_within_1e6_of_the_port_sdf_from_occupancy(n):
    rng = np.random.default_rng(n)
    img = np.ones((n, n))
    for _ in range(4):
        r, c = rng.integers(0, n - n // 5, 2)
        img[r:r + n // 5, c:c + n // 6] = 0.0
    res = 10.0 / n
    want = tsdf.sdf_from_occupancy(torch.tensor(img, dtype=torch.float32),
                                   res=res).numpy()
    np.testing.assert_allclose(native.sdf_2d(img > 0.75, res), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_rrt_star_gives_the_jax_package_path_when_max_iters_binds(seed):
    img = block_world()
    sdf = native.sdf_2d(img > 0.75, res=10 / 96)
    kw = dict(clearance=0.45, plan_time=60.0, max_iters=3000, seed=seed)
    got = native.rrt_star(sdf, (-4, -4), (4, 4), LIMS, LIMS, **kw)
    want = jnative.rrt_star(sdf, (-4, -4), (4, 4), LIMS, LIMS, **kw)
    assert got is not None and want is not None
    assert got.dtype == np.float32 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], [-4, -4], atol=1e-6)
    np.testing.assert_allclose(got[-1], [4, 4], atol=1e-6)
    # The resampled path clears the obstacle everywhere.
    interp = native.interpolate_path(got, 101)
    np.testing.assert_array_equal(interp,
                                  jnative.interpolate_path(want, 101))
    d, _ = tsdf.bilinear_lookup(torch.tensor(sdf)[None],
                                torch.tensor(interp, dtype=torch.float32)[None],
                                10 / 96, LIMS, LIMS)
    assert float(d.min()) > 0.4


def test_rrt_star_returns_none_when_no_path_exists():
    sdf = native.sdf_2d(np.zeros((32, 32)) > 0.75, res=10 / 32)
    assert native.rrt_star(sdf, (-4, -4), (4, 4), LIMS, LIMS,
                           clearance=0.4, plan_time=0.5, seed=0) is None
    # A wall across the world with no gap: the search itself finds nothing.
    img = np.ones((64, 64))
    img[:, 28:36] = 0.0
    sdf = native.sdf_2d(img > 0.75, res=10 / 64)
    assert native.rrt_star(sdf, (-4, 0), (4, 0), LIMS, LIMS, clearance=0.4,
                           plan_time=60.0, max_iters=2000, seed=1) is None


def test_a_failed_build_raises_with_the_command(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed") as info:
        native.load()
    assert "g++" in str(info.value) and str(broken) in str(info.value)
    assert "error" in str(info.value)
    assert native._lib is None and not native.available()
    with pytest.raises(RuntimeError):
        native.sdf_2d(np.ones((4, 4), bool), 1.0)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


def test_the_tracked_jax_library_is_untouched_by_the_port_build(monkeypatch,
                                                                 tmp_path):
    """The port compiles its own library and never writes or loads the JAX
    package's (dgpmp2_tpu/native/libdgpmp2_native.so, tracked in git)."""
    jax_lib = jnative._LIB
    before = hashlib.sha256(open(jax_lib, "rb").read()).hexdigest()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    built = native.library_path()
    assert built.is_file() and built.parent == tmp_path / "build"
    assert hashlib.sha256(open(jax_lib, "rb").read()).hexdigest() == before
    assert not os.path.samefile(built, jax_lib)
