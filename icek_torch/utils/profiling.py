"""Tracing and structured logging (port of ``icek_tpu/utils/profiling.py``,
the parts the train loop uses).

  * ``trace(logdir)``: a ``torch.profiler`` session over the block that
    writes a Chrome trace (``trace.json``) into `logdir`; with no directory
    it does nothing (enable in training with ``ICEK_PROFILE_DIR=/path``);
  * ``MetricLogger``: line-JSON records next to the human-readable prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


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
