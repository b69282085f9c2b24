"""Tracing and phase timing (counterpart of cadm_tpu/utils/profiling.py).

``device_trace`` records a ``torch.profiler`` trace of a block (CPU and,
where there is a card, CUDA activity) and exports it as a Chrome trace.
``PhaseTimer`` accumulates host-clock seconds per named phase; when the
phase hands over its result, the timer waits for the result's CUDA device
before reading the clock, since PyTorch returns before the card finishes.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict

import torch

from cadm_tpu_torch.utils.debug import leaves_with_path


def force_completion(out: Any) -> None:
    """Wait until every CUDA device holding a tensor of ``out`` is done."""
    devices = {leaf.device for _, leaf in leaves_with_path(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json``
    (chrome://tracing or Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulates wall-clock per named phase (collect / plan / fit ...)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block; a result stored in the yielded dict's
        ``"result"`` is waited for before the clock is read."""
        t0 = time.perf_counter()
        out: Dict[str, Any] = {}
        try:
            yield out
        finally:
            if "result" in out:
                force_completion(out["result"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}_sec_per_call": self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}
