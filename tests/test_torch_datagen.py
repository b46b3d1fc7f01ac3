"""The port's data generation (dgpmp2_tpu_torch.data) against the JAX
package's (dgpmp2_tpu.data).

Sampling and rejection are host numpy in both packages, so the same
``np.random.default_rng(seed)`` must give the same worlds, starts and goals
and leave the generator in the same state, through every retry, salvage and
RRT* seed: the samplers and map families are held bit-equal, state
included.  The expert labels are float32 plans in both packages (the JAX
generators plan in float32 whatever the x64 flag); after a 5-iteration plan
``th_opt`` is held to 1e-4 absolute, ``th_init`` and the SDFs to 1e-6.
RRT* runs with ``max_iters`` binding long before its time budget, so its
paths are deterministic.  Everything runs on the CPU (``device="cpu"``).
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from dgpmp2_tpu import native as jnative
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.data import dataset as jds
from dgpmp2_tpu.data import generate as jgen
from dgpmp2_tpu.data import generate3d as jgen3
from dgpmp2_tpu.data import generate_im as jgim
from dgpmp2_tpu.data import generate_paths as jgp
from dgpmp2_tpu.data import obstacles as jobs
from dgpmp2_tpu.data import obstacles3d as jobs3
from dgpmp2_tpu.data import sensitivity as jsens
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.data import dataset as tds
from dgpmp2_tpu_torch.data import generate as tgen
from dgpmp2_tpu_torch.data import generate3d as tgen3
from dgpmp2_tpu_torch.data import generate_im as tgim
from dgpmp2_tpu_torch.data import generate_paths as tgp
from dgpmp2_tpu_torch.data import obstacles as tobs
from dgpmp2_tpu_torch.data import obstacles3d as tobs3
from dgpmp2_tpu_torch.data import png
from dgpmp2_tpu_torch.data import sensitivity as tsens
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.robots import PointRobot2D as TPointRobot2D

torch.set_num_threads(1)
COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
           k_g=0.01)
LABEL_TOL = 1e-4  # th_opt: float32 plans of 5 iterations in two packages
INIT_TOL = 1e-6   # th_init and the SDFs
LIMS = (-5.0, 5.0)


def same_state(a: np.random.Generator, b: np.random.Generator):
    assert a.bit_generator.state == b.bit_generator.state


def twin_rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


# -- samplers and map families: bit-equal, generator state included --------

@pytest.mark.parametrize("family", jobs.FAMILIES)
def test_make_map_matches_jax(family):
    rj, rt = twin_rngs(7)
    for size, pts, pp, po in ((64, [(5, 5), (60, 60)], 4, 2),
                              (128, [(10.5, 100.2), (90, 12.7), (64, 64)],
                               9, 9),
                              (32, None, 0, 0)):
        for _ in range(3):
            want = jobs.make_map(family, rj, size, pts, pp, po)
            got = tobs.make_map(family, rt, size, pts, pp, po)
            np.testing.assert_array_equal(got, want)
            same_state(rj, rt)


@pytest.mark.parametrize("family", jobs3.FAMILIES3D)
def test_make_map3d_matches_jax(family):
    rj, rt = twin_rngs(5)
    for size, pts, pp, po in ((24, [(2, 2, 2), (21, 21, 21)], 3, 2),
                              (32, [(4.2, 27.9, 3.3), (28, 4, 27)], 6, 6),
                              (24, None, 0, 0)):
        for _ in range(2):
            want = jobs3.make_map3d(family, rj, size, pts, pp, po)
            got = tobs3.make_map3d(family, rt, size, pts, pp, po)
            np.testing.assert_array_equal(got, want)
            same_state(rj, rt)


SAMPLERS = {
    "sample_start_goal": (
        lambda m, r: m.sample_start_goal(r, 6, (-5.0, 5.0), (-4.0, 4.0)),
        jgen, tgen),
    "sample_diagonal": (
        lambda m, r: m.sample_diagonal(r, 5, (-5.0, 5.0), (-5.0, 5.0)),
        jgp, tgp),
    "sample_start_goal_3d": (
        lambda m, r: m.sample_start_goal_3d(r, 7, (-5.0, 5.0)), jgen3, tgen3),
    "world_to_pix": (
        lambda m, r: m.world_to_pix(r.uniform(-5, 5, (9, 2)), (-5.0, 5.0),
                                    (-5.0, 5.0), 10 / 128), jgen, tgen),
    "world_to_vox_zyx": (
        lambda m, r: m.world_to_vox_zyx(r.uniform(-5, 5, (9, 3)),
                                        (-5.0, 5.0), 10 / 32), jgen3, tgen3),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_match_jax(name):
    call, jmod, tmod = SAMPLERS[name]
    rj, rt = twin_rngs(11)
    for _ in range(4):
        want, got = call(jmod, rj), call(tmod, rt)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        same_state(rj, rt)


@pytest.mark.parametrize("gen", sorted(jgim.GENERATORS))
def test_generate_im_generators_match_jax(gen):
    rj, rt = twin_rngs(3)
    for size in (32, 128, 100):
        for _ in range(4):
            np.testing.assert_array_equal(tgim.GENERATORS[gen](rt, size),
                                          jgim.GENERATORS[gen](rj, size))
            same_state(rj, rt)


# -- generate_split ----------------------------------------------------------

def jax_split(out, rng, family="forest", n=2, probs=2, t=20, iters=5,
              method="lm", rrtstar=False):
    jgen.generate_split(
        str(out), n, probs, family, 64, rng,
        jgraph.GraphSpec(total_time_step=t), JPointRobot2D(),
        jgn.OptimConfig(reg=0.1, max_iters=iters, method=method), COV,
        rrtstar_init=rrtstar)


def port_split(out, rng, family="forest", n=2, probs=2, t=20, iters=5,
               method="lm", rrtstar=False):
    return tgen.generate_split(
        str(out), n, probs, family, 64, rng,
        tgraph.GraphSpec(total_time_step=t), TPointRobot2D(),
        tgn.OptimConfig(reg=0.1, max_iters=iters, method=method), COV,
        rrtstar_init=rrtstar, device="cpu")


def compare_split(jdir, tdir, n, probs):
    """The two packages' files of one split: images (as decoded) and
    starts/goals equal, SDFs and th_init to 1e-6, th_opt to 1e-4."""
    for e in range(n):
        a = png.read_png(os.path.join(jdir, "im_sdf", f"{e}_im.png"))
        b = png.read_png(os.path.join(tdir, "im_sdf", f"{e}_im.png"))
        np.testing.assert_array_equal(b, a)
        np.testing.assert_allclose(
            np.load(os.path.join(tdir, "im_sdf", f"{e}_sdf.npy")),
            np.load(os.path.join(jdir, "im_sdf", f"{e}_sdf.npy")),
            rtol=0, atol=INIT_TOL)
        for j in range(probs):
            name = os.path.join("opt_trajs_gpmp2", f"env_{e}_prob_{j}.npz")
            want = np.load(os.path.join(jdir, name))
            got = np.load(os.path.join(tdir, name))
            assert sorted(got.files) == sorted(want.files)
            for k in ("start", "goal"):
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_allclose(got["th_init"], want["th_init"],
                                       rtol=0, atol=INIT_TOL)
            np.testing.assert_allclose(got["th_opt"], want["th_opt"],
                                       rtol=0, atol=LABEL_TOL)
            assert got["th_opt"].dtype == np.float32


def cross_read(jroot, troot, mode="train"):
    """Each package's dataset reads the other's files: the same items."""
    for root_a, root_b in ((jroot, troot), (troot, jroot)):
        t_items = tds.PlanningDataset(str(root_a), mode=mode)
        j_items = jds.PlanningDataset(str(root_b), mode=mode)
        assert len(t_items) == len(j_items)
        for i in range(len(t_items)):
            a, b = t_items[i], j_items[i]
            for k in ("im", "start", "goal"):
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
            for k, tol in (("sdf", INIT_TOL), ("th_opt", LABEL_TOL)):
                np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0,
                                           atol=tol)


@pytest.mark.parametrize("family,method,t", [("forest", "lm", 20),
                                             ("multi_obs", "gauss_newton",
                                              10)])
def test_generate_split_matches_jax(tmp_path, family, method, t):
    rj, rt = twin_rngs(0)
    jax_split(tmp_path / "j" / "train", rj, family, t=t, method=method)
    stats = port_split(tmp_path / "t" / "train", rt, family, t=t,
                       method=method)
    same_state(rj, rt)
    compare_split(tmp_path / "j" / "train", tmp_path / "t" / "train", 2, 2)
    cross_read(tmp_path / "j", tmp_path / "t")
    assert stats["plans"] >= stats["attempts"] >= 2
    if family == "forest":
        # Some forest labels collide at T=20, so their pairs were resampled
        # against the same map: the stream stays in step through salvage.
        assert stats["plans"] > stats["attempts"], stats
    with open(tmp_path / "t" / "train" / "meta.yaml") as fp:
        meta = yaml.safe_load(fp)
    with open(tmp_path / "j" / "train" / "meta.yaml") as fp:
        assert meta == yaml.safe_load(fp)


def test_generate_split_rrtstar_init_matches_jax(tmp_path, monkeypatch):
    """RRT* seeds (``rng.integers(1 << 31)`` per problem), with RRT* held to
    1500 samples so its paths are deterministic."""
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "rrt_star", functools.partial(
            mod.rrt_star, max_iters=1500))
    rj, rt = twin_rngs(4)
    jax_split(tmp_path / "j", rj, "multi_obs", t=10, rrtstar=True)
    stats = port_split(tmp_path / "t", rt, "multi_obs", t=10, rrtstar=True)
    same_state(rj, rt)
    assert stats["rrt_found"] >= 4 and stats["rrt_searches"] >= 4
    compare_split(tmp_path / "j", tmp_path / "t", 2, 2)
    # The seeds are RRT* paths, not straight lines.
    z = np.load(tmp_path / "t" / "opt_trajs_gpmp2" / "env_0_prob_0.npz")
    line = np.linspace(z["start"][:2], z["goal"][:2], 11)
    assert np.abs(z["th_init"][:, :2] - line).max() > 1e-3


def test_generate_split_labels_clear_the_robot(tmp_path):
    """The generator's own guarantee, read back from disk through the plain
    lookup: every label's states clear the robot radius."""
    port_split(tmp_path / "train", np.random.default_rng(1))
    d = tds.PlanningDataset(str(tmp_path), mode="train")
    for i in range(len(d)):
        item = d[i]
        dist, _ = tsdf.bilinear_lookup(
            torch.tensor(item["sdf"])[None],
            torch.tensor(item["th_opt"][None, :, :2]), 10 / 64, LIMS, LIMS)
        assert float(dist.min()) > TPointRobot2D().sphere_radii[0]


# -- generate_split3d ---------------------------------------------------------

def test_generate_split3d_matches_jax(tmp_path):
    rj, rt = twin_rngs(2)
    kw = dict(t=10, max_iters=5)
    jgen3.generate_split3d(str(tmp_path / "j"), 2, 2, "boxes3d", 16, rj, **kw)
    stats = tgen3.generate_split3d(str(tmp_path / "t"), 2, 2, "boxes3d", 16,
                                   rt, device="cpu", **kw)
    same_state(rj, rt)
    assert stats["plans"] == stats["attempts"] >= 2
    for e in range(2):
        for k, tol in (("vox", 0.0), ("sdf", INIT_TOL)):
            np.testing.assert_allclose(
                np.load(tmp_path / "t" / "im_sdf" / f"{e}_{k}.npy"),
                np.load(tmp_path / "j" / "im_sdf" / f"{e}_{k}.npy"),
                rtol=0, atol=tol)
    # Each package's loader reads the other's split.
    for a, b in ((tgen3.load_split3d(str(tmp_path / "j")),
                  jgen3.load_split3d(str(tmp_path / "t"))),
                 (tgen3.load_split3d(str(tmp_path / "t")),
                  jgen3.load_split3d(str(tmp_path / "j")))):
        a, b = list(a), list(b)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            vox, sdf, start, goal, th_opt, th_init = x
            np.testing.assert_array_equal(vox, y[0])
            np.testing.assert_array_equal(start, y[2])
            np.testing.assert_array_equal(goal, y[3])
            np.testing.assert_allclose(sdf, y[1], rtol=0, atol=INIT_TOL)
            np.testing.assert_allclose(th_init, y[5], rtol=0, atol=INIT_TOL)
            np.testing.assert_allclose(th_opt, y[4], rtol=0, atol=LABEL_TOL)
    with open(tmp_path / "t" / "meta.yaml") as fp:
        meta = yaml.safe_load(fp)
    with open(tmp_path / "j" / "meta.yaml") as fp:
        assert meta == yaml.safe_load(fp)


# -- generate_im and add_expert_paths ------------------------------------------

def same_env(jdir, tdir, i):
    """One world's files: the SDF byte for byte, the image as decoded (the
    two packages' PNG encoders compress differently)."""
    name = os.path.join("im_sdf", f"{i}_sdf.npy")
    assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    name = os.path.join("im_sdf", f"{i}_im.png")
    np.testing.assert_array_equal(png.read_png(str(tdir / name)),
                                  png.read_png(str(jdir / name)))


def test_generate_im_matches_jax(tmp_path):
    jgim.generate(str(tmp_path / "j"), "multi_obstacle", 48, 3, 2, seed=1)
    tgim.generate(str(tmp_path / "t"), "multi_obstacle", 48, 3, 2, seed=1)
    for mode, n in (("train", 3), ("test", 2)):
        for i in range(n):
            same_env(tmp_path / "j" / mode, tmp_path / "t" / mode, i)
        assert ((tmp_path / "j" / mode / "meta.yaml").read_text()
                == (tmp_path / "t" / mode / "meta.yaml").read_text())


def test_image_folder_reads_pngs_without_matplotlib(tmp_path, monkeypatch):
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        png.write_png(str(folder / f"{i}.png"),
                      png.gray_rgba(rng.random((40, 30)) > 0.3))
    jgim.generate(str(tmp_path / "j"), "image", 32, 2, 1,
                  im_folder=str(folder), seed=2)
    # The port's PNG path must not import matplotlib (the card's host has
    # none).
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    tgim.generate(str(tmp_path / "t"), "image", 32, 2, 1,
                  im_folder=str(folder), seed=2)
    for i in range(2):
        same_env(tmp_path / "j" / "train", tmp_path / "t" / "train", i)


@pytest.mark.parametrize("scheme", ["random", "diagonal"])
def test_add_expert_paths_matches_jax(tmp_path, scheme):
    tgim.generate(str(tmp_path / "j"), "multi_obstacle", 48, 2, 0, seed=1)
    tgim.generate(str(tmp_path / "t"), "multi_obstacle", 48, 2, 0, seed=1)
    cov = dict(COV, cost_sigma=0.1, epsilon_dist=0.3)
    cfg = dict(reg=0.1, max_iters=5)
    rj, rt = twin_rngs(0)
    nj = jgp.add_expert_paths(
        str(tmp_path / "j" / "train"), 2, scheme,
        jgraph.GraphSpec(total_time_step=16), JPointRobot2D(sphere_radii=(0.3,)),
        jgn.OptimConfig(**cfg), cov, rj)
    nt = tgp.add_expert_paths(
        str(tmp_path / "t" / "train"), 2, scheme,
        tgraph.GraphSpec(total_time_step=16),
        TPointRobot2D(sphere_radii=(0.3,)), tgn.OptimConfig(**cfg), cov, rt,
        device="cpu")
    assert nj == nt == 2
    same_state(rj, rt)
    compare_split(tmp_path / "j" / "train", tmp_path / "t" / "train", 2, 2)
    cross_read(tmp_path / "j", tmp_path / "t")


def test_add_expert_paths_raises_on_unsolvable_env(tmp_path):
    tgim.generate(str(tmp_path), "multi_obstacle", 32, 1, 0, seed=0)
    with pytest.raises(RuntimeError, match="no collision-free"):
        tgp.add_expert_paths(
            str(tmp_path / "train"), 1, "diagonal",
            tgraph.GraphSpec(total_time_step=8),
            TPointRobot2D(sphere_radii=(100.0,)),
            tgn.OptimConfig(reg=0.1, max_iters=5), COV,
            np.random.default_rng(0), max_retries=2, device="cpu")


# -- run_sweep -----------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    port_split(root / "train", np.random.default_rng(3), "multi_obs", n=3,
               t=10, iters=8, method="gauss_newton")
    return root


def test_run_sweep_matches_jax(sweep_data):
    sigmas, bs, t = (0.05, 0.5, 5.0), 2, 10
    cfg = dict(reg=0.1, max_iters=5)
    want = jsens.run_sweep(
        jds.PlanningDatasetMulti([str(sweep_data)]), np.arange(6),
        jgraph.GraphSpec(total_time_step=t), JPointRobot2D(),
        jgn.OptimConfig(**cfg), sigmas, bs)
    got = tsens.run_sweep(
        tds.PlanningDatasetMulti([str(sweep_data)]), np.arange(6),
        tgraph.GraphSpec(total_time_step=t), TPointRobot2D(),
        tgn.OptimConfig(**cfg), sigmas, bs, device="cpu")
    assert got["best_sigma"] == want["best_sigma"]
    assert sorted(got["per_sigma"]) == sorted(want["per_sigma"])
    for s, w in want["per_sigma"].items():
        g = got["per_sigma"][s]
        assert sorted(g) == sorted(w)
        for k in ("solve_rate", "contact_free_rate", "avg_in_coll",
                  "avg_in_contact"):
            assert g[k] == w[k], (s, k)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{s} {k}")


# -- the CLIs --------------------------------------------------------------------

def test_the_clis_run_on_the_cpu(tmp_path):
    d2, im, d3 = tmp_path / "d2", tmp_path / "im", tmp_path / "d3"
    tgen.main(["--out_folder", str(d2), "--dataset_type", "multi_obs",
               "--im_size", "32", "--num_train", "2", "--num_test", "1",
               "--probs_per_env", "2", "--total_time_step", "8",
               "--max_iters", "10", "--device", "cpu"])
    assert len(tds.PlanningDataset(str(d2), mode="train")) == 4
    assert len(tds.PlanningDataset(str(d2), mode="test")) == 2
    tgim.main(["--out_folder", str(im), "--im_size", "32", "--num_train",
               "2", "--num_test", "0"])
    assert tgp.main(["--dataset_folder", str(im), "--probs_per_env", "2",
                     "--total_time_step", "8", "--max_iters", "5",
                     "--epsilon_dist", "0.3", "--device", "cpu"]) == 2
    assert len(tds.PlanningDataset(str(im), mode="train")) == 4
    tgen3.main(["--out", str(d3), "--num_envs", "1", "--probs", "2",
                "--size", "16", "--t", "8", "--device", "cpu"])
    assert len(list(tgen3.load_split3d(str(d3)))) == 2
    out = tsens.main(["--dataset_folders", str(d2), "--out_file",
                      str(tmp_path / "sens.yaml"), "--sigmas", "0.05", "0.5",
                      "--batch_size", "2", "--total_time_step", "8",
                      "--max_iters", "3", "--device", "cpu"])
    with open(tmp_path / "sens.yaml") as fp:
        assert yaml.safe_load(fp)["best_sigma"] == out["best_sigma"]


def test_the_generators_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device`` a generator plans on "cuda", which raises here
    (no card) rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tgen.generate_split(
            str(tmp_path), 1, 1, "multi_obs", 32, np.random.default_rng(0),
            tgraph.GraphSpec(total_time_step=8), TPointRobot2D(),
            tgn.OptimConfig(max_iters=2), COV)


def test_the_port_remakes_the_data_golden_on_the_cpu(tmp_path):
    """chip_smoke.py's check of the random stream on the card, here on the
    CPU: the JAX package's small forest split (tools/
    make_torch_port_golden.py --data) remade by the port."""
    import chip_smoke

    errs, stats = chip_smoke.data_golden_errors(torch.device("cpu"),
                                                tmp_path / "golden")
    assert chip_smoke.data_golden_ok(errs), errs
    assert stats["plans"] > stats["attempts"]  # a salvage happened
    assert os.path.getsize(chip_smoke.GOLDEN_DATA) < 50_000
