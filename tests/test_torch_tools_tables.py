"""The tables of dgpmp2_tpu_torch.tools, and what every tool shares, on the
CPU: no planning but in the headline chain's run.

``headline_campaign.assemble_table`` on a temporary copy of the committed
``runs/headline`` YAMLs (the midi scale, with and without the arm stage)
equals the JAX tool's ``assemble_table`` on the same copy line for line,
but for the "Regenerate" command line, which names the port's module;
``--check`` exits non-zero on drift.  The other tools' table writers
reproduce the committed tables from the committed YAMLs: ``plan3d_sweep``
the header and the five rows of ``runs/plan3d/table.md``, and the tables of
the headline run's stages and of ``runs/init_forest``.  ``runs/`` itself is
never written.  The JAX tools' constants equal the port's copies; the
package lists the eight tools, each of which raises without a card unless
``--device cpu`` is given; and ``headline_campaign --scale smoke`` runs
its whole chain end to end (the smoke scale at T=8 on 32² worlds
generated beforehand, which the campaign reads instead of generating).
"""
import argparse
import importlib
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu_torch.tools import TOOLS
from dgpmp2_tpu_torch.tools import headline_campaign as hc
from dgpmp2_tpu_torch.tools import init_experiment as ie
from dgpmp2_tpu_torch.tools import learned_campaign as lc
from dgpmp2_tpu_torch.tools import multistart_sweep as msw
from dgpmp2_tpu_torch.tools import plan3d_sweep as p3

from _torch_tools import ARGS, ROOT, campaign_data, jax_tool, yaml_of

torch.set_num_threads(1)
RUNS = ROOT / "runs"
REGENERATE = ("Regenerate with:", "Regenerate:")


def headline_copy(tmp_path) -> Path:
    """The committed headline run's YAMLs (not its tables) under
    ``tmp_path``."""
    out = tmp_path / "headline"
    for src in (RUNS / "headline").rglob("*.yaml"):
        dst = out / src.relative_to(RUNS / "headline")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    return out


def without_regenerate(text: str) -> list:
    return [x for x in text.splitlines() if not x.startswith(REGENERATE)]


@pytest.mark.parametrize("arm", [False, True])
def test_assemble_table_matches_the_jax_tools(tmp_path, arm):
    out = headline_copy(tmp_path)
    args = argparse.Namespace(out=str(out), scale="midi", arm=arm)
    jt = jax_tool("headline_campaign")
    want = Path(jt.assemble_table(args, jt.SCALES["midi"])).read_text()
    got = Path(hc.assemble_table(args, hc.SCALES["midi"])).read_text()
    assert without_regenerate(got) == without_regenerate(want)
    assert len(got.splitlines()) == len(want.splitlines())
    regen = [x for x in got.splitlines() if x.startswith(REGENERATE)]
    assert regen == [f"Regenerate with: `python -m dgpmp2_tpu_torch.tools."
                     f"headline_campaign --out {out} --scale midi`  "]
    assert ("## Arm transfer" in got) == arm


def test_check_exits_non_zero_on_drift(tmp_path, monkeypatch):
    out = headline_copy(tmp_path)
    monkeypatch.setattr(hc, "run", lambda args: hc.assemble_table(
        args, hc.SCALES[args.scale]))
    argv = ["--out", str(out), "--scale", "midi", "--device", "cpu"]
    got = hc.main(argv + ["--check", str(out / "headline.md")])
    assert got["path"] == str(out / "headline.md")
    drifted = tmp_path / "drifted.md"
    drifted.write_text(got["table"].replace("0.", "1.", 1))
    with pytest.raises(SystemExit) as exc:
        hc.main(argv + ["--check", str(drifted)])
    assert exc.value.code == 1


def test_plan3d_table_reproduces_the_committed_one():
    args = argparse.Namespace(out="runs/plan3d", envs=20, probs=4, size=48,
                              t=30, restarts=16, seed=0)
    results = yaml_of(RUNS / "plan3d" / "results.yaml")
    # The tool's order of the families (the YAML sorts them).
    got = p3.table({f: results[f] for f in p3.obstacles3d.FAMILIES3D}, args)
    want = (RUNS / "plan3d" / "table.md").read_text().splitlines()
    lines = got.splitlines()
    assert lines[0] == want[0]
    assert lines[4:] == want[4:11]  # the header and the five rows
    assert lines[2] == (
        "Regenerate: `python -m dgpmp2_tpu_torch.tools.plan3d_sweep --out "
        "runs/plan3d --envs 20 --probs 4 --size 48 --seed 0`")


def test_the_other_tables_reproduce_the_committed_ones():
    """Each from its committed YAML, its rows (the YAML sorts them) in the
    order of the run that wrote the table."""
    headline = RUNS / "headline"
    assert lc.results_table(yaml_of(headline / "results.yaml")) + "\n" == (
        headline / "table.md").read_text()
    arm = yaml_of(headline / "arm" / "results.yaml")
    assert lc.results_table({"static_best": arm["static_best"], **arm}) \
        + "\n" == (headline / "arm" / "table.md").read_text()
    by_family = yaml_of(headline / "results_by_family.yaml")
    assert lc.family_table({f: by_family[f] for f in hc.FAMILIES}) + "\n" \
        == (headline / "per_family.md").read_text()
    ms = yaml_of(headline / "multistart" / "results.yaml")
    args = argparse.Namespace(restarts=32, prune_iters=10, keep=8)
    assert msw.table(ms, args) + "\n" == (
        headline / "multistart" / "table.md").read_text()
    init = yaml_of(RUNS / "init_forest" / "results.yaml")
    order = ("expert_ceiling", "raw_initnet", "static_straight_best",
             "static_initnet_best", "multistart16_straight_best",
             "multistart16_initnet_best", "eps_bounded_straight",
             "eps_bounded_initnet")
    assert ie.table({k: init[k] for k in order}) + "\n" == (
        RUNS / "init_forest" / "table.md").read_text()


def test_the_headline_constants_equal_the_jax_tools():
    jt = jax_tool("headline_campaign")
    assert hc.SCALES == jt.SCALES
    assert hc.MS_CONTROL_SIGMAS == jt.MS_CONTROL_SIGMAS
    assert hc.FAMILIES == jt.FAMILIES
    assert hc.HEADLINE_CONFIG == jt.HEADLINE_CONFIG


def test_the_package_lists_the_eight_tools():
    jax_side = {"learned_campaign", "headline_campaign", "arm_campaign",
                "init_experiment", "learn3d_campaign", "multistart_sweep",
                "plan3d_sweep", "arm_multistart_eval"}
    assert set(TOOLS) == jax_side and len(TOOLS) == 8
    for name in TOOLS:
        assert (ROOT / "tools" / f"{name}.py").exists()
        assert callable(importlib.import_module(
            f"dgpmp2_tpu_torch.tools.{name}").main)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", TOOLS)
def test_each_tool_raises_without_a_card(name, tmp_path):
    m = importlib.import_module(f"dgpmp2_tpu_torch.tools.{name}")
    data = {"multistart_sweep": ["--data_root", str(tmp_path)],
            "init_experiment": ["--data", str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.main(["--out", str(tmp_path), *data])
    assert list(tmp_path.iterdir()) == []


def test_headline_smoke_runs_end_to_end(tmp_path, monkeypatch):
    out = tmp_path / "headline"
    s = hc.SCALES["smoke"]
    campaign_data(out, hc.FAMILIES, s["num_train"], s["num_test"],
                  s["probs"], t=8)
    monkeypatch.setitem(hc.SCALES, "smoke", dict(s, t=8))
    got = hc.main(["--out", str(out), "--scale", "smoke", *ARGS])
    assert got["path"] == str(out / "headline.md")
    chip_smoke.check_tool_files("headline_campaign", out)
    text = got["table"]
    assert text.startswith("# Headline campaign — scale `smoke`, config "
                           "`eps_bounded`")
    for fam in hc.FAMILIES:
        assert f"| {fam} |" in text
    ms = yaml_of(out / "multistart" / "results.yaml")
    assert sorted(ms) == sorted(hc.FAMILIES)
    assert all("eps_bounded_ms4" in rows for rows in ms.values())
    assert np.isfinite(yaml_of(out / "results.yaml")["eps_bounded"][
        "solve_rate"])


# -- chip_smoke.py phase 18's checks, on the CPU ---------------------------------

def test_yaml_keys_read_sigmas_as_one_key():
    tree = {"a": {0.01: {"solve_rate": 1.0}, 0.5: {"solve_rate": 0.0}},
            "b": [{"epoch": 0}]}
    assert chip_smoke.yaml_keys(tree) == {(0, "a"), (0, "b"), (1, "*"),
                                          (2, "solve_rate"), (2, "epoch")}
    assert chip_smoke.yaml_keys(tree, skip=1) == {(1, "*"),
                                                  (2, "solve_rate"),
                                                  (2, "epoch")}


@pytest.mark.parametrize("tree,ok", [
    ({"x": {"solve_rate": 1.0, "avg_gp_error": 3.5}}, True),
    ({"x": {"learned_val_solve": 0.5, "history": [{"loss": 2.0}]}}, True),
    ({"x": {"solve_rate": 1.5}}, False),
    ({"x": {"contact_free_rate": -0.1}}, False),
    ({"x": {"avg_gp_error": float("nan")}}, False),
    ({"x": [1.0, float("inf")]}, False),
])
def test_check_yaml_tree_holds_rates_and_finite_numbers(tree, ok):
    if ok:
        chip_smoke.check_yaml_tree("t", tree)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_yaml_tree("t", tree)


@pytest.mark.parametrize("name,counts,ok", [
    ("learned_campaign", dict(btd_solve=120, sdf_lookup=130,
                              sdf_lookup_bwd=20), True),
    ("learned_campaign", dict(btd_solve=120, sdf_lookup=130), False),
    ("multistart_sweep", dict(btd_solve=100, sdf_lookup=104,
                              sdf_lookup_bwd=10), False),
    ("multistart_sweep", dict(btd_solve=90, sdf_lookup=104), False),
    ("plan3d_sweep", dict(btd_solve=100, sdf_lookup3d=105), True),
    ("plan3d_sweep", dict(btd_solve=100, sdf_lookup=105), False),
    ("arm_multistart_eval", dict(btd_solve=100, sdf_lookup=104,
                                 sdf_lookup_limbs=1), False),
])
def test_check_tool_counts_holds_each_tools_kernels(name, counts, ok):
    counts = dict(dict.fromkeys(chip_smoke.KERNELS, 0), limb_splits=0,
                  **counts)
    rec = {"plans": 2, "iters": 100}
    if ok:
        chip_smoke.check_tool_counts(name, counts, rec)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_tool_counts(name, counts, rec)


def test_phase18_runs_a_tool_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.run_tool`` on the CPU, the kernel wrappers counting
    their plain versions: the 3-D sweep's launches are K-BTD one a counted
    iteration, K-LOOKUP3D one a lookup and nothing else."""
    from _torch_examples import count_plain_launches

    count_plain_launches(monkeypatch)
    monkeypatch.setattr(chip_smoke, "TOTALS",
                        dict.fromkeys(chip_smoke.KERNELS, 0))
    out, wall = chip_smoke.run_tool(
        "plan3d_sweep", ["--out", str(tmp_path / "p3"), "--envs", "1",
                         "--probs", "2", "--size", "16", "--t", "6",
                         "--restarts", "16", "--dtype", "float64"],
        torch.device("cpu"), "CPU", tmp_path)
    assert sorted(out) == sorted(p3.obstacles3d.FAMILIES3D) and wall > 0
    totals = chip_smoke.TOTALS
    # 5 families: 5 sigmas of LM 50, then 10 + 40 staged multistart.
    assert totals["btd_solve"] == 5 * (5 * 50 + 50)
    assert totals["sdf_lookup3d"] > 0
    assert totals["sdf_lookup"] == totals["sdf_lookup_bwd"] == 0
    assert (tmp_path / "plan3d_sweep.log").read_text().startswith(
        "[boxes3d] sigma=0.01")
    chip_smoke.check_tool_files("plan3d_sweep", tmp_path / "p3")
