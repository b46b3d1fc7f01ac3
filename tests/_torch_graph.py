"""The captured-loop machinery of ``core.gn`` on the CPU: a fake CUDA graph
and the fixture that routes CPU plans through it (``core.gn.plan``'s and
``LearnedDiffGPMP2Planner.plan``'s loops alike)."""
import contextlib

import pytest

from dgpmp2_tpu_torch.core import gn
from dgpmp2_tpu_torch.utils import profiling
from dgpmp2_tpu_torch.utils.tree import leaves


class EagerCapture(gn._CapturedPlan):
    """The captured loop with its graph replaced: "capture" runs the call
    on the static buffers, and each "replay" runs it there again and writes
    its outputs over the captured ones, as a graph's replay does; neither
    is counted by the kernel wrappers, as on the card."""

    def __init__(self, args, tensors, run, consts=()):
        self.run = run
        super().__init__(args, tensors, run, consts)

    def _capturing(self):
        return contextlib.nullcontext()

    def _ordered(self):
        return contextlib.nullcontext()

    def _replay(self):
        # A graph's replay runs no Python: the wrappers count nothing.
        out, _ = profiling.capture(lambda: self.run(*self.args),
                                   contextlib.nullcontext())
        for dst, src in zip(leaves(self.out), leaves(out)):
            dst.copy_(src)

    def reset(self):
        self.run = None


@pytest.fixture
def fake_card(monkeypatch):
    """Plans on the CPU take the captured path through the fake graph;
    graphs and counts start empty and are dropped after."""
    monkeypatch.setattr(gn, "_GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(gn, "_CapturedPlan", EagerCapture)
    gn._reset_graphs()
    yield
    gn._reset_graphs()
