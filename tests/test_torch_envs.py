"""dgpmp2_tpu_torch.envs (Env2D, Env3D) against dgpmp2_tpu.envs, in float64
on the CPU: SDFs, distance queries and their gradients, transforms and
feasibility to 1e-12 on the worlds of ``tests/test_aux.py:75-103`` (64²,
one obstacle) and ``test_plan3d.py:163-176`` (32³, a central box); file
initialisation through the port's PNG reader; a rendering smoke test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.envs import Env2D as JEnv2D
from dgpmp2_tpu.envs import Env3D as JEnv3D
from dgpmp2_tpu_torch import envs as tenvs
from dgpmp2_tpu_torch.data import png
from dgpmp2_tpu_torch.ops import sdf as tsdf

from _torch_parity import F64, np_

torch.set_num_threads(1)
TOL = 1e-12
LIMS2 = {"x_lims": (-5.0, 5.0), "y_lims": (-5.0, 5.0)}
LIMS3 = dict(LIMS2, z_lims=(-5.0, 5.0))


def close(got, want, tol=TOL):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def aux_image():
    img = np.ones((64, 64))
    img[20:30, 40:50] = 0.0
    return img


def box_voxels(n=32):
    vox = np.ones((n, n, n))
    vox[12:20, 12:20, 12:20] = 0.0
    return vox


@pytest.fixture(scope="module")
def envs2d():
    j = JEnv2D(LIMS2)
    j.initialize_from_image(aux_image())
    t = tenvs.Env2D(LIMS2, device="cpu", dtype=F64)
    t.initialize_from_image(aux_image())
    return j, t


@pytest.fixture(scope="module")
def envs3d():
    j = JEnv3D(LIMS3)
    j.initialize_from_voxels(box_voxels())
    t = tenvs.Env3D(LIMS3, device="cpu", dtype=F64)
    t.initialize_from_voxels(box_voxels())
    return j, t


def query_points(rng, n, ndim):
    """Uniform points over the world and 10 % beyond it (clamped OOB)."""
    return rng.uniform(-5.5, 5.5, (n, ndim))


def test_env2d_sdf_queries_and_gradients_match_jax(envs2d):
    j, t = envs2d
    assert t.sedt.dtype == F64 and t.sedt.device.type == "cpu"
    close(t.sedt, j.sedt)
    assert t.res == j.res and t.MAX_D == j.MAX_D
    pts = query_points(np.random.default_rng(0), 500, 2)
    (d, g), (dj, gj) = (t.get_signed_obstacle_distance(pts),
                        j.get_signed_obstacle_distance(jnp.asarray(pts)))
    assert d.shape == (500,) and g.shape == (500, 2)
    close(d, dj)
    close(g, gj)
    # Any leading shape (JAX's Env2D takes (N, 2) only).
    d2, g2 = t.get_signed_obstacle_distance(pts.reshape(20, 25, 2))
    assert torch.equal(d2, d.reshape(20, 25))
    assert torch.equal(g2, g.reshape(20, 25, 2))
    # A query equals the port's plain lookup of the same points.
    d, g = t.get_signed_obstacle_distance(pts)
    d0, g0 = tsdf.bilinear_lookup(t.sedt[None], torch.tensor(pts)[None],
                                  t.res, t.x_lims, t.y_lims)
    assert torch.equal(d, d0[0]) and torch.equal(g, g0[0])


def test_env2d_transforms_and_feasibility_match_jax(envs2d):
    j, t = envs2d
    pts = query_points(np.random.default_rng(1), 200, 2)
    pix = t.to_pixel(pts)
    assert pix.dtype == F64
    close(pix, j.to_pixel(pts))
    close(t.to_world(pix), j.to_world(np_(pix)))
    close(t.to_world(pix), pts)  # the round trip
    for p in ((-4.0, -4.0), (2.05, 1.1), (4.9, -4.9), (7.0, 0.0)):
        assert t.in_limits(p) == j.in_limits(p)
        for eps in (0.0, 0.3):
            assert t.is_feasible(p, eps) == j.is_feasible(p, eps)
    assert t.is_feasible((-4.0, -4.0), eps=0.3)
    assert not t.is_feasible((2.05, 1.1), eps=0.3)


def test_env2d_from_file_matches_jax(tmp_path):
    """An RGBA PNG: the port reads it without matplotlib; JAX with
    ``plt.imread``; the same image, luma and SDF."""
    img = aux_image()
    path = tmp_path / "world.png"
    png.write_png(path, png.gray_rgba(img))
    j = JEnv2D(LIMS2)
    j.initialize_from_file(str(path))
    t = tenvs.Env2D(LIMS2, device="cpu", dtype=F64)
    t.initialize_from_file(str(path))
    close(t.image, j.image)
    close(t.sedt, j.sedt)


def test_env3d_matches_jax(envs3d):
    j, t = envs3d
    close(t.sedt, j.sedt)
    pts = query_points(np.random.default_rng(2), 400, 3)
    (d, g), (dj, gj) = (t.get_signed_obstacle_distance(pts),
                        j.get_signed_obstacle_distance(pts))
    close(d, dj)
    close(g, gj)
    # test_plan3d.py:170-176's points against the raw lookup.
    raw = np.asarray([[0.0, 0.0, 0.0], [-4.0, -4.0, -4.0]])
    d, g = t.get_signed_obstacle_distance(raw)
    d0, g0 = tsdf.trilinear_lookup(t.sedt, torch.tensor(raw), t.res,
                                   t.x_lims, t.y_lims, t.z_lims)
    assert torch.equal(d, d0) and torch.equal(g, g0)
    vox = t.to_voxel_xyz(pts)
    close(vox, j.to_voxel_xyz(pts))
    close(t.to_world(vox), j.to_world(np_(vox)))
    close(t.to_world(vox), pts)
    for p in ((0.0, 0.0, 0.0), (-4.0, -4.0, -4.0), (0.0, 0.0, 6.0)):
        assert t.in_limits(p) == j.in_limits(p)
        assert t.is_feasible(p, 0.2) == j.is_feasible(p, 0.2)


def test_env3d_slice_is_the_true_field(envs3d):
    j, t = envs3d
    for z in (-5.0, -0.2, 0.4, 5.0):
        sj, st = j.slice_env2d(z), t.slice_env2d(z)
        iz = int(round(-t.z_lims[0] / t.res + z / t.res))
        iz = max(0, min(31, iz))
        assert torch.equal(st.sedt, t.sedt[iz])
        close(st.sedt, sj.sedt)
        np.testing.assert_array_equal(st.image, sj.image)
        assert (st.device, st.dtype) == (t.device, t.dtype)


def test_env_defaults_to_the_card_and_keeps_its_dtype():
    assert tenvs.Env2D(LIMS2).device == torch.device("cuda")
    env = tenvs.Env2D(LIMS2, device="cpu")
    env.initialize_from_image(aux_image())
    assert env.sedt.dtype == torch.float32
    d, g = env.get_signed_obstacle_distance(np.zeros((3, 2)))
    assert d.dtype == g.dtype == torch.float32


def test_env2d_renders_headless(envs2d, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, t = envs2d
    t.initialize_plot(start=(-4, -4), goal=(4, 4))
    t.plot_edge([(-4, -4), (0, 0), (4, 4)])
    t.plot_edge(torch.tensor([[-4.0, 4.0], [4.0, -4.0]]), color="red")
    t.save_plot(str(tmp_path / "env.png"))
    t.close_plot()
    t.plot_signed_distance_transform()
    t.plot_costmap(0.4)
    plt.close("all")
    img = png.read_png(tmp_path / "env.png")
    assert img.ndim == 3 and img.shape[0] > 100
