"""Tracing and per-step timing (port of
``fcl_taco2_tpu/train/profiler.py``).

- ``trace(log_dir, rank)``: a ``torch.profiler`` context with CPU
  activity and, where a card is present, CUDA activity; on exit it writes
  a Chrome trace (``trace.json``, or ``trace.rank<k>.json`` for rank k of
  a data-parallel run; viewable in Perfetto or chrome://tracing) into
  ``log_dir``.  The trainer wraps its first epoch in it when
  ``profile_dir`` is set (``loop.py:446-447``).
- ``cost_analysis(fn, *args)``: the flops of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``; bytes are -1, as the JAX
  version returns where a backend gives none.
- ``StepTimer``: host-clock durations of the last ``window`` steps as
  p50 / p90 / max.  On the card a step's host time covers its device time
  only where the step ends in a synchronization (the trainer's metric
  flush does).
"""

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir, rank=None):
    """Profile the block; write ``log_dir/trace.json`` at its end, or
    ``trace.rank<rank>.json`` when a ``rank`` is given."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = TRACE_FILE if rank is None else f"trace.rank{rank}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def cost_analysis(fn, *args):
    """{"flops": flops of ``fn(*args)``, "bytes_accessed": -1.0}."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": -1.0}


class StepTimer:
    def __init__(self, window=100):
        self.window = window
        self._durs = []
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self, n=1):
        """``n``: optimizer steps covered since ``tic`` (a chained
        dispatch records its wall divided by its steps)."""
        if self._t is not None:
            self._durs.append((time.perf_counter() - self._t) / max(1, n))
            self._t = None
            if len(self._durs) > self.window:
                self._durs = self._durs[-self.window:]

    def summary(self):
        if not self._durs:
            return {}
        d = np.asarray(self._durs)
        return {
            "step_ms_p50": float(np.percentile(d, 50) * 1e3),
            "step_ms_p90": float(np.percentile(d, 90) * 1e3),
            "step_ms_max": float(d.max() * 1e3),
        }
