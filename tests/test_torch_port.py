"""The port as a whole: the stored JAX golden, import hygiene and the rule
that the CUDA path has no fallback."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.ops.cuda import _build
from dgpmp2_tpu_torch.ops.cuda import btd_solve as k_btd
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k_lookup
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as k_lookup3d
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_bwd as k_bwd
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as k_limbs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_plan_matches_the_jax_golden():
    """The B=8 bench problem, 5 GN iterations in float64 (the check that
    chip_smoke.py repeats on the card with the kernels): 1e-8 relative."""
    out, g = chip_smoke.golden_plan(torch.device("cpu"))
    errs = chip_smoke.golden_errors(out, g)
    assert all(v <= 1e-8 for v in errs.values()), errs
    assert os.path.getsize(chip_smoke.GOLDEN) < 300_000


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, dgpmp2_tpu_torch, dgpmp2_tpu_torch.convert, "
        "dgpmp2_tpu_torch.utils.config, dgpmp2_tpu_torch.ops.cuda.btd_solve, "
        "dgpmp2_tpu_torch.ops.cuda.sdf_lookup, dgpmp2_tpu_torch.ops.cuda._build, "
        "dgpmp2_tpu_torch.ops.cuda.sdf_lookup3d, "
        "dgpmp2_tpu_torch.ops.cuda.sdf_lookup_limbs, "
        "dgpmp2_tpu_torch.core.multistart, dgpmp2_tpu_torch.utils.angles, "
        "dgpmp2_tpu_torch.utils.mat_utils, "
        "dgpmp2_tpu_torch.ops.cuda.sdf_lookup_bwd, "
        "dgpmp2_tpu_torch.learn.losses, dgpmp2_tpu_torch.learn.train, "
        "dgpmp2_tpu_torch.learn.checkpoints, dgpmp2_tpu_torch.learn.eval, "
        "dgpmp2_tpu_torch.learn.train_planner, "
        "dgpmp2_tpu_torch.learn.test_planner, "
        "dgpmp2_tpu_torch.learn.train_initializer, "
        "dgpmp2_tpu_torch.data.dataset, dgpmp2_tpu_torch.data.png, "
        "dgpmp2_tpu_torch.data.obstacles, dgpmp2_tpu_torch.data.obstacles3d, "
        "dgpmp2_tpu_torch.data.generate, dgpmp2_tpu_torch.data.generate3d, "
        "dgpmp2_tpu_torch.data.generate_paths, "
        "dgpmp2_tpu_torch.data.generate_im, "
        "dgpmp2_tpu_torch.data.sensitivity, dgpmp2_tpu_torch.core.seeds, "
        "dgpmp2_tpu_torch.native, dgpmp2_tpu_torch.core.dense, "
        "dgpmp2_tpu_torch.envs, dgpmp2_tpu_torch.utils.profiling, "
        "dgpmp2_tpu_torch.parallel.sharding\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dgpmp2_tpu', "
        "'matplotlib')]\n"
        "assert not bad, bad\n"
        "from dgpmp2_tpu_torch.ops.cuda import _build\n"
        "assert _build._lib is None and dgpmp2_tpu_torch.native._lib is None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# Public names of dgpmp2_tpu that the port does not export: none.
NOT_PORTED_NAMES = frozenset()


def test_all_covers_the_reference_public_names():
    """The port's ``__all__`` holds every public name of dgpmp2_tpu (its
    non-module attributes and ``__version__``), less NOT_PORTED_NAMES, and
    each of them imports; ``from dgpmp2_tpu_torch import PlanningService,
    Env2D, plan_multistart`` works."""
    import types

    import dgpmp2_tpu
    import dgpmp2_tpu_torch

    from dgpmp2_tpu_torch import Env2D, PlanningService, plan_multistart

    public = {n for n, v in vars(dgpmp2_tpu).items()
              if (not n.startswith("_") or n == "__version__")
              and not isinstance(v, types.ModuleType)}
    assert {"PlanningService", "Env2D", "Env3D", "plan_multistart",
            "MultistartResult", "PlanRequest"} <= public
    assert public - NOT_PORTED_NAMES <= set(dgpmp2_tpu_torch.__all__)
    assert all(hasattr(dgpmp2_tpu_torch, n) for n in dgpmp2_tpu_torch.__all__)
    assert dgpmp2_tpu_torch.__version__ == dgpmp2_tpu.__version__
    assert (Env2D.__module__, PlanningService.__module__,
            plan_multistart.__module__) == (
        "dgpmp2_tpu_torch.envs", "dgpmp2_tpu_torch.serve",
        "dgpmp2_tpu_torch.core.multistart")


def test_package_sources_never_name_jax():
    for path in (ROOT / "dgpmp2_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for word in ("import jax", "from jax", "import flax", "from flax",
                     "import optax", "import orbax", "from dgpmp2_tpu ",
                     "from dgpmp2_tpu.", "import dgpmp2_tpu\n"):
            assert word not in text, f"{path}: {word!r}"


def test_missing_nvcc_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert _build._lib is None


def test_failed_build_names_the_command(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no such target") as info:
        _build.library()
    assert "sm_90a" in str(info.value) and str(fake) in str(info.value)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    d = torch.eye(4, dtype=torch.float64).expand(2, 5, 4, 4).contiguous()
    off = torch.zeros((2, 4, 4, 4), dtype=torch.float64)
    rhs = torch.ones((2, 5, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        k_btd.launch(d, off, rhs)
    with pytest.raises(ValueError, match="D >= 1; got D=0"):
        k_btd.launch(torch.zeros((2, 5, 0, 0)), torch.zeros((2, 4, 0, 0)),
                     torch.zeros((2, 5, 0)))
    sdf = torch.zeros((2, 8, 8), dtype=torch.float64)
    pts = torch.zeros((2, 3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        k_lookup.launch(sdf, pts, 10 / 8, (-5.0, 5.0), (-5.0, 5.0))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        k_lookup.launch(sdf[0], pts[0], 10 / 8, (-5.0, 5.0), (-5.0, 5.0))
    # The dispatchers take the plain versions for CPU tensors.
    tridiag.btd_solve_auto(d, off, rhs)
    tsdf.lookup(sdf, pts, 10 / 8, (-5.0, 5.0), (-5.0, 5.0))
    assert k_btd.launches == 0 and k_lookup.launches == 0


def test_new_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    lims = (-5.0, 5.0)
    sdf = torch.zeros((2, 8, 8, 8), dtype=torch.float64)
    pts = torch.zeros((2, 3, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        k_lookup3d.launch(sdf, pts, 10 / 8, lims, lims, lims)
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        k_lookup3d.launch(sdf[0], pts, 10 / 8, lims, lims, lims)
    packed = k_limbs.split(sdf[:, 0], 2)
    pts2 = torch.zeros((2, 3, 2), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k_limbs.launch(packed, pts2, 10 / 8, lims, lims)
    with pytest.raises(ValueError, match="packed limb layout"):
        k_limbs.launch(packed[..., :1].repeat(1, 1, 1, 3), pts2, 10 / 8, lims,
                       lims)
    # The dispatchers take the plain versions for CPU tensors.
    tsdf.lookup_nd(sdf, pts, 10 / 8, lims, lims, lims)
    k_limbs.limb_lookup(sdf[:, 0], packed, pts2, 10 / 8, lims, lims)
    assert k_lookup3d.launches == 0 and k_limbs.launches == 0


def test_lookup_bwd_kernel_refuses_cpu_tensors_and_counts_nothing():
    """K-LOOKUP-BWD launches on CUDA tensors only; on the CPU the lookups'
    backward is plain autograd, and nothing counts."""
    lims = (-5.0, 5.0)
    sdf = torch.zeros((2, 8, 8), dtype=torch.float64)
    pts = torch.zeros((2, 3, 2), dtype=torch.float64, requires_grad=True)
    d_bar, g_bar = torch.zeros((2, 3)), torch.zeros((2, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        k_bwd.launch(sdf, pts.detach(), d_bar.double(), g_bar.double(),
                     10 / 8, (lims, lims))
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        k_bwd.launch(sdf, pts.detach(), d_bar, g_bar, 10 / 8,
                     (lims, lims, lims))
    d, g = tsdf.lookup(sdf, pts, 10 / 8, lims, lims)
    (d.sum() + g.sum()).backward()
    assert pts.grad is not None and k_bwd.launches == 0


def test_build_covers_every_source_and_binds_every_entry_point():
    """The library's hash reads every csrc source, the header included, and
    _SIGNATURES names exactly the extern "C" entry points of the sources."""
    import re

    names = {p.name for p in _build._sources()}
    assert {"btd_solve.cu", "sdf_lookup.cu", "sdf_lookup3d.cu",
            "sdf_lookup_limbs.cu", "sdf_lookup_bwd.cu",
            "lookup_common.cuh"} <= names
    exported = set()
    for path in _build._sources():
        exported |= set(re.findall(r'extern "C" int (\w+)\(',
                                   path.read_text()))
    assert exported == set(_build._SIGNATURES)


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without a card it exits non-zero and prints no result; alone in a
    directory it cannot even import the port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("inst", sorted(chip_smoke.STREAM_INSTANCES))
def test_ring_edge_systems_hold_their_bound_on_the_cpu(inst, monkeypatch):
    """chip_smoke.stream_system's random systems (phase 19's check of the
    lane-group kernel at the ring's edges) come in the instance's dtypes
    with the per-plan blocks and one family's Λ shared at batch stride 0,
    and stream_system_err holds the plain version, standing in for the
    kernel on the CPU, within the bound phase 19 holds the kernel to."""
    from dgpmp2_tpu_torch.ops.cuda import btd_stream as k_stream

    monkeypatch.setattr(k_stream, "launch", k_stream.plain)
    monkeypatch.setattr(k_btd, "btd_solve_cuda", tridiag.btd_solve)
    rng = np.random.default_rng(0)
    ta, tr = chip_smoke.STREAM_INSTANCES[inst]
    for b, t1, d, lm in ((1, 1, 3, True), (7, 2, 16, False), (5, 6, 4, True)):
        args, kw = chip_smoke.stream_system(rng, b, t1, d, inst,
                                            torch.device("cpu"), lm)
        assert args[0].dtype == ta and args[6].dtype == tr
        assert args[0].shape[0] == 1 and args[9][0].w.shape[:2] == (1, 1)
        assert (kw["delta"] is not None) == lm
        err, tol = chip_smoke.stream_system_err(args, kw)
        assert err <= tol, (b, t1, d, lm, err, tol)
