"""Tracing / profiling helpers.

Counterpart of ``singlecarrier_tpu/runtime/profiling.py``.  The
reference's only instrumentation is a printf per detected frame
(reference: src/qpsk.c:196-200).  Here: a ``torch.profiler`` trace
capture, a log of the port's compiles (kernel-library builds and the
first load of a geometry: a steady-state streaming loop must do none),
and a simple throughput meter for streaming loops.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..ops import _build

_log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a CPU and (where there is a card) CUDA trace of the block,
    written as a Chrome trace (``*.pt.trace.json``, viewable in Perfetto
    or TensorBoard) into ``log_dir`` (``sc_torch_trace`` in the
    temporary directory by default).  Yields ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "sc_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


@contextlib.contextmanager
def log_compiles():
    """Log (at WARNING, as ``jax.log_compiles`` does) every kernel-library
    build and first load of a kernel geometry inside the block
    (``ops/_build.build`` / ``load``).  Yields the list the events are
    appended to, so a caller can require it to stay empty."""
    events: list = []

    def listener(event: str) -> None:
        events.append(event)
        _log.warning("compile: %s", event)

    _build.COMPILE_LISTENERS.append(listener)
    try:
        yield events
    finally:
        _build.COMPILE_LISTENERS.remove(listener)


@dataclass
class ThroughputMeter:
    """Samples/s meter for streaming demod loops."""
    samples: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, n_samples: int) -> None:
        self.samples += n_samples

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.elapsed, 1e-9)

    def summary(self, fs: float = 8000.0) -> dict:
        sps = self.samples_per_sec
        return {
            "samples": self.samples,
            "wall_s": round(self.elapsed, 4),
            "samples_per_sec": round(sps, 1),
            "realtime_channels": int(sps / fs),
        }
