"""BENCHMARK.json, the files it names, and the harness finding new cells,
configurations, traffic mixes and metrics by name alone."""
import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHCH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module", params=["benchmark", "with_pending"])
def bench(request):
    """BENCHMARK.json, and with the pending cells' entries added."""
    return getattr(spec, request.param)()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in bench["command"])
    assert bench["paths"] == ["portbench"]
    assert all(PATHCH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entries(bench):
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in bench[group]:
            assert set(entry) == keys
            assert NAME.match(entry["name"]) and entry["name"] not in names
            names.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert spec.load_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    metric_names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metric_names
        metric_names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_loads_and_reports_enough(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench=bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert set(cell.settings["limits"]) == {
            "init_err_gap", "step1_err_gap", "final_err_gap",
            "final_err_excess"}
        assert spec.system(cell.config).Driver


def test_metric_files_agree_with_the_benchmark(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"],
                                                      m["source"])
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_new_files_are_found_by_name_alone(tmp_path):
    """A later PR adds a configuration, a traffic mix, a cell and a metric
    as new files and entries; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    here = root / "portbench"
    cfg = json.loads((here / "configs" / "point2d.json").read_text())
    cfg.update(name="point2d_t50")
    cfg["planner_params"]["total_time_step"] = 50
    (here / "configs" / "point2d_t50.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "forest_b1024.json").read_text())
    traffic.update(name="forest_b512", batch=512)
    (here / "traffic" / "forest_b512.json").write_text(json.dumps(traffic))
    cell = json.loads((here / "cells" / "point2d.b10240.json").read_text())
    cell.update(name="point2d_t50.b512")
    (here / "cells" / "point2d_t50.b512.json").write_text(json.dumps(cell))
    (here / "metrics" / "calls_traced.py").write_text(
        'UNIT, BETTER, SOURCE = "calls", "higher", "device_trace"\n'
        'LAYER, MOVES, CELLS = "host loop", "plans_per_s", '
        '["point2d_t50.b512"]\n\n'
        'def read(ctx):\n    return None if ctx.trace is None else '
        'ctx.trace.calls\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "point2d_t50", "source": "x",
                             "file": "portbench/configs/point2d_t50.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "point2d_t50.b512",
                               "config": "point2d_t50",
                               "traffic": "forest_b512", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "host loop", "moves": "plans_per_s",
                               "workloads": ["point2d_t50.b512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    got = spec.cell("point2d_t50.b512", root=root, here=here)
    assert got.config["planner_params"]["total_time_step"] == 50
    assert got.traffic["batch"] == 512
    assert "calls_traced" in [m["name"] for m in got.per_layer]
    mod = spec.reader("calls_traced", here=here)
    assert mod.read(type("C", (), {"trace": None})()) is None
    for p, data in before.items():
        assert p.read_bytes() == data
    # The cells already there read the same as before.
    old = spec.cell("point2d.b10240", root=root, here=here)
    assert "calls_traced" not in [m["name"] for m in old.per_layer]


def test_unknown_cell_is_a_key_error():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
