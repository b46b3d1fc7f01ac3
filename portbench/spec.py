"""What a run reads by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its own run settings (``cells/<cell>.json``)
and one reader per metric (``metrics/<metric>.py``).

A later cell, configuration, traffic mix or metric is a new file found by
its name; nothing here lists them.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def with_pending(root: Path = ROOT, here: Path = HERE) -> dict:
    """``BENCHMARK.json`` with the entries of ``pending/*.json`` added: cells
    built and checked but not yet steady enough for a bound (the tests run
    them on the CPU; a later PR moves the entries into ``BENCHMARK.json``)."""
    bench = copy.deepcopy(benchmark(root))
    layer = {m["name"]: m for m in bench["per_layer"]}
    for path in sorted((here / "pending").glob("*.json")):
        pend = load_json(path)
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += pend.get(key, [])
        for w in pend.get("workloads", []):
            for name in pend.get("per_layer_also", []):
                layer[name]["workloads"].append(w["name"])
    return bench


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with a ``workloads`` list is reported in those cells; one
    without it in every cell that reports the end-to-end metric it moves
    (an end-to-end metric without the list: in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT, here: Path = HERE,
         bench: dict = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json``);
    KeyError names what is missing."""
    bench = benchmark(root) if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    settings = load_json(here / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, settings=settings, end_to_end=e2e,
                per_layer=layer)


def reader(metric: str, here: Path = HERE):
    """The module of ``metrics/<metric>.py`` (loaded by path, so a name
    with a dot is a file like any other)."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def system(config: dict):
    """The module of ``systems/<system>.py`` that drives a configuration."""
    return importlib.import_module(f"portbench.systems.{config['system']}")
