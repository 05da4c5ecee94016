"""Profiling and timing helpers.

Counterpart of ``pygenray_tpu/utils/profiling.py``.  On a CUDA card the
tools are a ``torch.profiler`` device trace (a Chrome trace, viewable in
Perfetto or ``chrome://tracing``) and wall-clock phases that end with
``torch.cuda.synchronize()``: PyTorch returns before the card finishes, so
a phase that does not wait for it measures the enqueue only.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["device_trace", "Timer", "timed"]


def _sync():
    """Wait for the card's pending work, when there is a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    operations, and the card's kernels when there is a card) and write it
    to ``<logdir>/trace.json`` as a Chrome trace.  Yields the profiler, so
    the caller can also read ``key_averages()``.

    Example::

        with device_trace("trace_dir") as prof:
            fan = pt.shoot_rays(...)
        print(prof.key_averages().table(sort_by="device_time_total"))
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Accumulating named phase timer with device synchronization."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        """Time a phase, yielding a callable that registers results made
        inside the block (as the JAX package's ``Timer.phase`` does)::

            with timer.phase("trace") as done:
                res = trace(...)
                done(res.ts)

        The clock stops after ``torch.cuda.synchronize()``, which waits for
        every registered result and all other pending work on the card,
        when ``sync`` is true (the default) or a result was registered.
        """
        pending = []

        def register(*arrays):
            pending.extend(arrays)
            return arrays[-1] if len(arrays) == 1 else arrays

        t0 = time.perf_counter()
        try:
            yield register
        finally:
            if pending or sync:
                _sync()
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>24s}: {v * 1e3:9.2f} ms ({v / total * 100:5.1f}%)" for k, v in self.phases.items()]
        lines.append(f"{'total':>24s}: {total * 1e3:9.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(label: str, result_holder: dict = None):
    """Wall-clock context, ended by ``torch.cuda.synchronize()`` when a
    card is in use; stores seconds under ``label``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        if result_holder is not None:
            result_holder[label] = dt
