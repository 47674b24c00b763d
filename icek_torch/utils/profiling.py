"""Tracing, step timing and structured logging (port of
``icek_tpu/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` session over the block that
    writes a Chrome trace (``trace.json``) into `logdir`; with no directory
    it does nothing (enable in training with ``ICEK_PROFILE_DIR=/path``);
  * ``StepTimer``: the data-load / step split of each iteration (the train
    loop's epoch record carries its summary);
  * ``MetricLogger``: line-JSON records next to the human-readable prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block (host and, where there is one, the CUDA device) if
    a log directory is given."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Tracks data-load time vs step (compute) time per iteration."""

    def __init__(self):
        self.data_s = 0.0
        self.step_s = 0.0
        self.steps = 0
        self._mark = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_s += now - self._mark
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step_s += now - self._mark
        self._mark = now
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        n = max(self.steps, 1)
        return {
            "steps": self.steps,
            "avg_data_ms": 1000.0 * self.data_s / n,
            "avg_step_ms": 1000.0 * self.step_s / n,
        }


class MetricLogger:
    """Append-only line-JSON metrics log (one object per event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields):
        if not self.path:
            return
        record = {"ts": time.time(), "event": event, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def profile_dir_from_env() -> Optional[str]:
    return os.environ.get("ICEK_PROFILE_DIR") or None
