"""The port's stream engine on the arms whose K-STREAM step runs the wide
(D = 17-32) and block (D > 32) kernels, against the JAX package, and the
launch plan of those kernels (plain Python).

A 9-link arm (D = 18) and a 17-link arm (D = 34), each with obstacles
(a full Λ), self-collision (a diagonal one) and joint limits, B = 2 and
T1 = 5 in float64 on the CPU: the port's ``stream.stream_step`` (the
kernel's plain version here) against JAX's standard assembly, damping and
solve, under GN and LM, at 1e-10 relative.  JAX's stream step is out of
reach at these arms on the CPU: it pads the batch to 1024 lanes and forms
each family's K x K x D products (9.7 GB for the 9-link arm's 115
self-collision pairs), and its Pallas sweeps in interpret mode took over
400 s at D = 18; tests/test_torch_stream.py holds the port to it at D = 4.
The plan: ``rows_chunks`` takes every family row once, in order, and
``rows_plan``'s layout fits the shared memory it is given, with no two
regions overlapping.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.ops import tridiag as jtridiag
from dgpmp2_tpu_torch import robots as tr
from dgpmp2_tpu_torch.core import graph as tg
from dgpmp2_tpu_torch.core import stream as tstream
from dgpmp2_tpu_torch.ops.cuda import btd_stream

from _torch_parity import F64, np_, world

torch.set_num_threads(1)
TOL = 1e-10
B, T = 2, 4
# chip_smoke.py's 9-link arm's links, and that profile resampled at 17.
LINKS9 = (0.6, 0.5, 0.5, 0.45, 0.4, 0.4, 0.35, 0.3, 0.3)
LINKS17 = tuple(np.interp(np.linspace(0, 8, 17), np.arange(9), LINKS9)
                * 3.8 / np.interp(np.linspace(0, 8, 17), np.arange(9),
                                  LINKS9).sum())
ARMS = {"arm9": LINKS9, "arm17": LINKS17}
_CACHE = {}


def arm(name):
    """The arm problem in both packages (each from its own default_params)
    and JAX's residuals, with the port's copy of them."""
    if name in _CACHE:
        return _CACHE[name]
    links = ARMS[name]
    kw = dict(link_lengths=links, spheres_per_link=2, sphere_radii=(0.25,))
    j_robot, t_robot = jr.PlanarArmNLink(**kw), tr.PlanarArmNLink(**kw)
    dof = len(links)
    rng = np.random.default_rng(dof)
    spec_kw = dict(dof=dof, state_dim=2 * dof, total_time_step=T,
                   nlinks=t_robot.nlinks, use_self_collision=True,
                   use_joint_limits=True,
                   self_pairs=jr.self_collision_pairs(j_robot))
    imgs, _, _ = world(dof, B, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs),
                                             res=10.0 / 32))
    # Folded arms across limits: self-collision and joint limits bind.
    th = np.concatenate([rng.uniform(-3.0, 3.0, (B, T + 1, dof)),
                         rng.normal(0.0, 0.8, (B, T + 1, dof))], -1)
    pkw = dict(qc_inv=np.eye(dof), cost_sigma=0.2, epsilon_dist=0.6,
               k_s=0.01, k_g=0.05, k_self=0.05, eps_self=0.1, k_jl=0.1,
               q_min=[-1.5] * dof, q_max=[1.2] * dof)
    spec_j, spec_t = jg.GraphSpec(**spec_kw), tg.GraphSpec(**spec_kw)
    p_j = jg.default_params(spec_j, j_robot, jnp.asarray(th[:, 0] + 0.1),
                            jnp.asarray(th[:, -1] - 0.1), dtype=jnp.float64,
                            **pkw)
    p_t = tg.default_params(spec_t, t_robot, torch.tensor(th[:, 0] + 0.1),
                            torch.tensor(th[:, -1] - 0.1), dtype=F64, **pkw)
    res_j = jg.eval_residuals(spec_j, j_robot, p_j, jnp.asarray(th),
                              jnp.asarray(sdf))
    res_t = tg.FactorResiduals(**{
        f.name: None if getattr(res_j, f.name) is None
        else torch.tensor(np.asarray(getattr(res_j, f.name)))
        for f in dataclasses.fields(tg.FactorResiduals)})
    _CACHE[name] = (spec_j, p_j, res_j, spec_t, p_t, res_t)
    return _CACHE[name]


def rel(got, want):
    want = np_(want)
    return float(np.abs(np_(got) - want).max() / np.abs(want).max())


DELTAS = {"gn": 0.1, "lm": np.array([1e-3, 10.0])}


def port_step(spec, params, res, delta, lm):
    ss = tstream.build_stream_static(
        spec, params, tg.assemble_static(spec, params, F64), B, F64,
        0.0 if lm else delta)
    return tstream.stream_step(spec, params, ss, res, torch.tensor(delta), lm)


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("name", sorted(ARMS))
def test_arm_has_every_family_the_kernels_take(name, method):
    """The arm's step carries a full Λ (obstacles), a diagonal one
    (self-collision) and joint limits, at D = 18 or 34; the step is finite
    and of its shape under both methods."""
    spec_j, p_j, res_j, spec_t, p_t, res_t = arm(name)
    fams = tstream.families(spec_t, tstream.build_stream_static(
        spec_t, p_t, None, B, F64), res_t)
    shapes = [(f.h.shape[-2], f.diagonal) for f in fams]
    dof = len(ARMS[name])
    assert shapes == [(2 * dof, False), (dof, False),
                      (spec_t.num_self_pairs, True)]
    x = port_step(spec_t, p_t, res_t, DELTAS[method], method == "lm")
    assert x.shape == (B, T + 1, 2 * dof) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("name", sorted(ARMS))
def test_arm_stream_step_matches_jax_standard_step(name, method):
    spec_j, p_j, res_j, spec_t, p_t, res_t = arm(name)
    lm = method == "lm"
    delta = DELTAS[method]
    diag, off, rhs = jg.assemble_from_residuals(spec_j, p_j, res_j)
    want = jtridiag.btd_solve_auto(*jgn.damped_system(
        diag, off, rhs, jnp.asarray(delta), trust_region=lm))
    got = port_step(spec_t, p_t, res_t, delta, lm)
    assert rel(got, want) <= TOL, rel(got, want)


# -- the launch plan -----------------------------------------------------------

FS = btd_stream.FamilyShape
# The arms' families at B = 1024 (every Λ shared), phase 19 (a)'s random
# systems (a shared full Λ, a per-problem diagonal one), and edge cases: an
# empty family, a lone row, a per-problem full Λ.
FAMILY_SETS = {
    "arm9": (FS(18, False, True), FS(9, False, True), FS(115, True, True)),
    "arm17": (FS(34, False, True), FS(17, False, True), FS(411, True, True)),
    "random": (FS(3, False, True), FS(2, True, False)),
    "edges": (FS(0, True, True), FS(1, True, False), FS(5, False, False),
              FS(0, False, True), FS(65, True, False)),
}
SIZES = {"f32": (4, 4), "f64": (8, 8), "mixed": (8, 4)}
H100_OPTIN, H100_SMS = 232448, 132


def h100_occupancy(threads, smem):
    """Blocks an SM as an H100 allows them by threads and shared memory
    alone (2048 threads, 228 KiB with 1 KiB reserved a block)."""
    return min(2048 // threads, 233472 // (smem + 1024), 32)


@pytest.mark.parametrize("chunk_rows", [1, 7, 16, 32, 64, 500])
@pytest.mark.parametrize("fams", sorted(FAMILY_SETS))
def test_rows_chunks_take_every_row_once_in_order(fams, chunk_rows):
    shapes = FAMILY_SETS[fams]
    chunks = btd_stream.rows_chunks(shapes, chunk_rows)
    for n, f in enumerate(shapes):
        mine = [(k0, rows) for m, k0, rows in chunks if m == n]
        rows = [k for k0, r in mine for k in range(k0, k0 + r)]
        assert rows == list(range(f.k))
        assert len(mine) == (1 if not f.diagonal or f.k == 0
                             else -(-f.k // chunk_rows))
        assert all(r <= (chunk_rows if f.diagonal else max(f.k, 1))
                   for _, r in mine)
    assert [n for n, _, _ in chunks] == sorted(n for n, _, _ in chunks)


def _regions(plan, d, fams, ta, tr):
    """(start, end) bytes of each region of a plan's shared memory."""
    out = [(0, (2 * plan["stages"] + 2 * btd_stream.ROW_BUFFERS) * 8),
           (plan["ry_off"], plan["ry_off"] + 8 * d),
           (plan["stage_off"],
            plan["stage_off"] + plan["stages"] * plan["stage_bytes"])]
    chunks = btd_stream.rows_chunks(fams, plan["chunk_rows"])
    elems = max(rows * d for _, _, rows in chunks)
    assert plan["chunk_elems"] == elems
    out.append((plan["lh_off"], plan["lh_off"] + elems * 8))
    if tr == 4:
        out.append((plan["hd_off"], plan["hd_off"] + 8 * (
            elems + max(rows for _, _, rows in chunks))))
    for f, at in zip(fams, plan["lam"]):
        if at >= 0:
            out.append((at, at + (f.k if f.diagonal else f.k * f.k) * ta))
    if not plan["scratch_block"]:
        out.append((plan["rows_off"], plan["rows_off"] + 8 * (
            btd_stream.ROW_BUFFERS * d * (2 * d + 1) + d * (d + 1))))
    return out


@pytest.mark.parametrize("kind", sorted(SIZES))
@pytest.mark.parametrize("d", [17, 18, 24, 32, 33, 34, 48, 64, 80])
@pytest.mark.parametrize("fams", sorted(FAMILY_SETS))
def test_rows_plan_fits_the_shared_memory(fams, d, kind):
    shapes = FAMILY_SETS[fams]
    ta, tr_ = SIZES[kind]
    plan = btd_stream.rows_plan(d, 1024, ta, tr_, shapes, h100_occupancy,
                                H100_OPTIN, H100_SMS)
    assert plan["smem"] <= H100_OPTIN
    assert plan["kernel"] == ("wide" if d <= 32 else "block")
    assert plan["warps"] == (plan["consumers"] + plan["formers"] + 1)
    # Persistent grid: every block is resident, each taking its problems.
    assert plan["needed_blocks_per_sm"] <= plan["resident_blocks_per_sm"]
    assert plan["grid"] * plan["problems_per_block"] >= 1024
    regions = sorted(_regions(plan, d, shapes, ta, tr_))
    assert all(a % 16 == 0 for a, _ in regions)
    assert all(e <= s for (_, e), (s, _) in zip(regions, regions[1:]))
    assert regions[-1][1] <= plan["smem"]
    # Each stage holds its largest chunk.
    kept = [at >= 0 for at in plan["lam"]]
    for n, _, rows in btd_stream.rows_chunks(shapes, plan["chunk_rows"]):
        assert btd_stream._stage_need(d, rows, shapes[n], kept[n], ta,
                                      tr_) <= plan["stage_bytes"]
    assert kept == [f.shared for f in shapes] or not any(kept)
    # The rows leave shared memory only where they must.
    rows_bytes = 8 * (btd_stream.ROW_BUFFERS * d * (2 * d + 1)
                      + d * (d + 1))
    assert bool(plan["scratch_block"]) == (
        plan["rows_off"] < 0) and (plan["scratch_block"] == 0
                                   or plan["scratch_block"] >= rows_bytes)


def test_rows_plan_keeps_the_arms_resident_as_the_card_allows():
    """At B = 1024 the 9-link arm's wide plan holds 8 blocks an SM (one
    problem a block) and the 17-link arm's block plan 2-3, by the threads
    and shared memory of an H100."""
    for kind, (ta, tr_) in SIZES.items():
        p9 = btd_stream.rows_plan(18, 1024, ta, tr_, FAMILY_SETS["arm9"],
                                  h100_occupancy, H100_OPTIN, H100_SMS)
        p17 = btd_stream.rows_plan(34, 1024, ta, tr_, FAMILY_SETS["arm17"],
                                   h100_occupancy, H100_OPTIN, H100_SMS)
        assert p9["resident_blocks_per_sm"] >= 7, (kind, p9)
        assert p17["resident_blocks_per_sm"] >= 2, (kind, p17)
        assert p9["scratch_block"] == p17["scratch_block"] == 0


def test_rows_plan_honours_caps_and_refuses_what_cannot_fit():
    shapes = FAMILY_SETS["arm17"]
    caps = dict(formers=2, keep=False, stages=4, chunk_rows=16)
    plan = btd_stream.rows_plan(34, 1024, 8, 8, shapes, h100_occupancy,
                                H100_OPTIN, H100_SMS, caps)
    assert {k: plan[k] for k in ("formers", "stages", "chunk_rows")} == {
        k: v for k, v in caps.items() if k != "keep"}
    assert plan["lam"] == [-1, -1, -1]
    with pytest.raises(ValueError):
        btd_stream.rows_plan(34, 1024, 8, 8, shapes, h100_occupancy, 4096,
                             H100_SMS)
    with pytest.raises(ValueError):
        btd_stream.set_rows_plan(warps=3)
