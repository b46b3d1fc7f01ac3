"""Two torch.distributed processes (gloo, on the CPU) against one: the
port's ``make_multihost_mesh`` spans them (dcn = 2), each process plans
its half of a float64 batch through ``core.gn.plan`` and ``gather_batch``
all-gathers the plans, and one data-parallel training step (the head split
over two CPU entries inside each process, the gradients all-reduced across
the processes) equals the one-process step.  The children run
``chip_smoke.mesh_process``, phase 16 (c) of the card's smoke run, at a
small size (tests/_torch_multiproc_child.py); one run serves both tests.

Each child has its own timeouts: 60 s for a collective
(``init_process_group(timeout=)``), 120 s for the whole process, so that a
hang fails these tests and not the suite.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_torch_multiproc_child.py")
WORLD, TIMEOUT_S = 2, 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def records():
    """Each child's ``mesh_process`` record, after both exited 0."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), str(WORLD),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [x for x in out.splitlines() if x.startswith("mesh_process ")]
        assert p.returncode == 0 and len(line) == 1, (
            f"process {r} exited {p.returncode}:\n{out[-4000:]}")
        recs.append(json.loads(line[0][len("mesh_process "):]))
    return recs


def test_plan_across_two_processes_equals_one_process(records):
    """dcn = 2 (one data row of one CPU entry each): every row of the
    gathered plan equals the one-process plan, float32 and float64."""
    for rank, rec in enumerate(records):
        assert rec["rank"] == rank
        assert rec["mesh"] == {"dcn": WORLD, "data": 1, "model": 1}
        assert rec["plan_float32_max_abs_gap"] == 0.0
        assert rec["plan_float64_max_abs_gap"] <= 1e-12


def test_train_step_across_two_processes_equals_one_process(records):
    """dcn = 2 × model = 2: loss, metrics and every updated weight within
    1e-12 of the one-process step (the gradients within 1e-11), the weights
    bit-equal on both processes and the replicas inside each."""
    for rec in records:
        assert rec["train_mesh"] == {"dcn": WORLD, "data": 1, "model": 2}
        assert rec["train_max_rel_err"] <= 1e-12, rec["train_worst"]
        assert rec["train_grad_max_rel_err"] <= 1e-11, rec["train_grad_worst"]
        assert rec["weights_equal_on_every_process"]
        assert rec["replicas_equal"]
