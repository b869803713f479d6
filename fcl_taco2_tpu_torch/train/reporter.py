"""Metrics reporting: per-iteration scalar accumulation -> epoch summaries,
jsonl log, console table, optional PNG plots (the port's copy of
``fcl_taco2_tpu/train/reporter.py``; matplotlib is imported only inside
``plot``).

Replaces the chainer reporter + LogReport/PlotReport/PrintReport wiring
(tts.py:565-587, e2e_tts_tacotron2_sa.py:605-620).
"""

import json
import os
import threading
import time
from collections import defaultdict


class Reporter:
    def __init__(self, exp_dir, log_name="log.jsonl"):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self.log_path = os.path.join(exp_dir, log_name)
        self._sums = defaultdict(float)
        self._counts = defaultdict(float)
        self.history = []
        self._t0 = time.time()
        # report() and peek()/summarize() may run on different threads
        self._lock = threading.Lock()

    def report(self, scalars: dict, prefix="main", weight=1.0):
        """Accumulate scalars; the epoch summary is the WEIGHTED mean.

        ``weight``: contribution of this observation (validation passes the
        batch's valid-utterance count so the trailing partial batch does
        not over-count — the reference averages same-size batches,
        tts.py:71-108, so its skew is bounded; padded static batches need
        the explicit weight)."""
        with self._lock:
            for k, v in scalars.items():
                key = f"{prefix}/{k}"
                self._sums[key] += float(v) * weight
                self._counts[key] += weight

    def peek(self, keys=None):
        """Running means of the CURRENT epoch so far (for in-epoch progress
        lines, reference PrintReport/ProgressBar every 100 iterations,
        tts.py:584-587)."""
        with self._lock:
            keys = keys or sorted(self._sums)
            return {k: self._sums[k] / (self._counts[k] or 1.0)
                    for k in keys if k in self._sums}

    def summarize(self, epoch, step, extra=None, write=True):
        """``write=False`` defers the log.jsonl append (write_entry) so
        the caller can add late fields — e.g. the checkpoint wall times,
        which only exist after the entry's losses are needed to decide
        whether to checkpoint at all (train/loop.py)."""
        entry = {"epoch": epoch, "step": step,
                 "elapsed_sec": round(time.time() - self._t0, 2)}
        with self._lock:
            for k in sorted(self._sums):
                entry[k] = self._sums[k] / (self._counts[k] or 1.0)
            self._sums.clear()
            self._counts.clear()
        if extra:
            entry.update(extra)
        self.history.append(entry)
        if write:
            self.write_entry(entry)
        return entry

    def write_entry(self, entry):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def print_entry(self, entry, keys=None):
        keys = keys or [k for k in entry if "/" in k]
        parts = [f"epoch {entry['epoch']:>3} step {entry['step']:>7}"]
        parts += [f"{k.split('/', 1)[1]}={entry[k]:.4f}"
                  for k in keys if k in entry]
        print("  ".join(parts), flush=True)

    def plot(self, keys=None):
        """Per-key PNG curves (reference PlotReport, tts.py:565-581).
        Matplotlib is optional; silently skipped if unavailable."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        if not self.history:
            return
        all_keys = keys or sorted(
            {k for e in self.history for k in e if "/" in k})
        # ONE reused figure for every PNG (matplotlib's per-figure setup
        # is the cost)
        fig = plt.figure(figsize=(7, 5))
        ax = fig.add_subplot(111)
        for key in all_keys:
            xs = [e["epoch"] for e in self.history if key in e]
            ys = [e[key] for e in self.history if key in e]
            if not xs:
                continue
            ax.clear()
            ax.plot(xs, ys)
            ax.set_xlabel("epoch")
            ax.set_ylabel(key)
            ax.grid(True)
            fname = key.replace("/", "_") + ".png"
            fig.savefig(os.path.join(self.exp_dir, fname))
        # combined loss plot (reference all_loss.png, tts.py:565-581)
        loss_keys = [k for k in all_keys if k.endswith("loss")]
        if loss_keys:
            ax.clear()
            for key in loss_keys:
                xs = [e["epoch"] for e in self.history if key in e]
                ys = [e[key] for e in self.history if key in e]
                if xs:
                    ax.plot(xs, ys, label=key)
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax.legend(fontsize=7)
            ax.grid(True)
            fig.savefig(os.path.join(self.exp_dir, "all_loss.png"))
        plt.close(fig)
