"""The port's profiling helpers (``pygenray_tpu_torch/utils/profiling.py``):
counterparts of ``tests/test_aux.py::TestProfilingUtils``, on the CPU.
``device_trace`` starts ``torch.profiler`` (over a second on a CPU), so it
is exercised on the card, by ``chip_smoke.split_ms``."""

import torch

from pygenray_tpu_torch.utils.profiling import Timer, timed


class TestProfilingUtils:
    def test_timer_phases(self):
        t = Timer()
        with t.phase("a"):
            _ = sum(range(1000))
        with t.phase("b") as done:
            done(torch.ones(3) * 2)
        rep = t.report()
        assert "a" in rep and "b" in rep and "total" in rep
        assert set(t.phases) == {"a", "b"} and all(v >= 0.0 for v in t.phases.values())

    def test_timed(self):
        holder = {}
        with timed("x", holder):
            pass
        assert "x" in holder and holder["x"] >= 0.0
