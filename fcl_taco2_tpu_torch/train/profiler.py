"""Per-step wall timing (the port's ``StepTimer`` of
``fcl_taco2_tpu/train/profiler.py``; the device trace is not ported yet).

``StepTimer`` keeps the host-clock durations of the last ``window`` steps
and summarizes them as p50 / p90 / max.  On the card a step's host time
covers its device time only where the step ends in a synchronization
(the trainer's metric flush and non-finite check do).
"""

import time

import numpy as np


class StepTimer:
    def __init__(self, window=100):
        self.window = window
        self._durs = []
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self, n=1):
        """``n``: optimizer steps covered since ``tic``."""
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
