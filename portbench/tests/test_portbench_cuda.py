"""On the card: a short run of each cell is correct and well formed, and the
control at the cell's own size is not correct.

    python -m pytest portbench/tests/test_portbench_cuda.py -m cuda

Each test skips where torch sees no CUDA device (decided inside the test).
"""
import json
import subprocess
import sys

import pytest
import torch

from portbench import control, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(name, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for m in result["metrics"].values():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(name):
    _card()
    cell = spec.cell(name)
    got = control.read(cell, 2**31 + 98, torch.bfloat16,
                       torch.device("cuda", 0))
    assert not got["correct"], got
