"""The closed loop every serving driver shares: one client that sends
call i + 1 when call i's answer is on the host.

A driver subclass makes the program (``build``), sends one call
(``call(i)`` -> the answer: one array an utterance) and recomputes a call
with the plain reference (``reference(i, pr)`` -> one array an utterance
and, for each, the (start, end) of the leading axis to compare).  The calls are
``corpus.calls(mix, seed)``, sent in order and from the start again when
the window outlasts them, so every shape a window can meet is warmed in
set-up.
"""

import sys
import time

import numpy as np
import torch

from benchmark import corpus
from benchmark import trace as tracing
from benchmark.reference.precision import Precision


# the steps in which ``warm`` groups the calls: finer than the phoneme and
# frame buckets of every entry point of the program
WARM_TOKENS, WARM_FRAMES = 16, 64


def _ceil(x, m):
    return -(-int(x) // int(m))


class ClosedLoop:
    def __init__(self, config, mix, seed, device, options=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.options = dict(options or {})
        self.calls = corpus.calls(mix, seed)
        self.next = 0
        self.kept = {}        # the first calls' answers, for the sample
        self.longest = None   # (frames, call, answer) of the longest

    # ---- what a driver provides ----
    def build(self):
        raise NotImplementedError

    def call(self, i):
        raise NotImplementedError

    def reference(self, i, pr):
        raise NotImplementedError

    def free(self):
        raise NotImplementedError

    def graphs(self):
        """The program's ``Graphed`` of the entry point (its captures)."""
        raise NotImplementedError

    # ---- the loop ----
    def facts(self, i):
        """(phonemes, frames) of each utterance of call ``i``."""
        return {"utts": [(len(u.tokens), u.frames)
                         for u in self.calls[i][0]]}

    def frames(self, i):
        return sum(u.frames for u in self.calls[i][0])

    def warm(self):
        """One call of each shape group the calls hold: the longest
        utterance's phonemes in steps of ``WARM_TOKENS`` and the most
        frames in steps of ``WARM_FRAMES``."""
        groups = {}
        for i, (utts, _) in enumerate(self.calls):
            key = (_ceil(max(len(u.tokens) for u in utts), WARM_TOKENS),
                   _ceil(max(u.frames for u in utts), WARM_FRAMES))
            groups.setdefault(key, i)
        for i in groups.values():
            self.call(i)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _send(self):
        i = self.next % len(self.calls)
        self.next += 1
        return i, self.call(i)

    def window(self, run, seconds):
        keep_first = 4 * int(self.mix["sample"])
        self._sync()
        t0 = time.perf_counter()
        end, last = t0 + seconds, t0
        while time.perf_counter() < end:
            run.attempted += 1
            ts = time.perf_counter()
            try:
                i, answer = self._send()
            except Exception as e:  # an answer that never comes
                run.failed += 1
                print(f"benchmark: call failed: {e!r}", file=sys.stderr)
                continue
            last = time.perf_counter()
            run.latencies.append(last - ts)
            run.calls.append(self.facts(i))
            if len(self.kept) < keep_first:
                self.kept.setdefault(i, answer)
            f = self.frames(i)
            if self.longest is None or f > self.longest[0]:
                self.longest = (f, i, answer)
        run.window_s = last - t0

    def trace(self, run):
        """Two short traced sub-windows of ``trace_calls`` more calls each:
        the card's activity alone (busy time, kernel times: the host runs
        as untraced), then the host's too (what the host did while the
        card sat idle)."""
        def calls(done):
            def body():
                for _ in range(int(self.mix["trace_calls"])):
                    with torch.profiler.record_function("bench.call"):
                        done.append(self._send()[0])
            return body

        done = []
        dev, _, window = tracing.record(calls(done), host=False)
        dev_h, host, _ = tracing.record(calls([]), host=True)
        run.traced = {"dev": dev, "window_s": window,
                      "calls": [self.facts(i) for i in done],
                      "idle_gaps": tracing.idle_by_host(dev_h, host)}

    def sample(self):
        """The compared calls: ``sample`` of the first calls' answers,
        drawn from the seed, and the longest call the window finished."""
        rng = np.random.default_rng(corpus.split_seed(self.seed, "sample"))
        keys = sorted(self.kept)
        pick = rng.choice(len(keys), min(int(self.mix["sample"]),
                                         len(keys)), replace=False)
        out = {keys[k]: self.kept[keys[k]] for k in sorted(pick)}
        if self.longest is not None:
            out[self.longest[1]] = self.longest[2]
        return out

    def control_answers(self):
        """The sample's answers as the reference computes them one
        precision below the stated one (the control of the check)."""
        pr = Precision("control")
        return {i: [ref.detach().float().cpu().numpy()
                    for ref, _ in self.reference(i, pr)]
                for i in self.sample()}

    def fault_answers(self):
        """The sample's answers with a fault whose mean gap is nought, so
        that only a number other than ``bias_err`` can see it: the frames
        (or samples) of the longest sampled utterance in reverse order."""
        answers = {i: list(a) for i, a in self.sample().items()}
        i, b = max(((i, b) for i, a in answers.items()
                    for b in range(len(a))),
                   key=lambda ib: len(answers[ib[0]][ib[1]]))
        answers[i][b] = answers[i][b][::-1].copy()
        return {"reversed": answers}

    def check(self, answers=None):
        """The numbers the check can compare, of the program's sampled
        answers (or of ``answers``) against the reference, each over the
        reference's pooled RMS: the largest gap over an utterance's RMS
        (``max_err``), the pooled RMS gap (``rms_err``), the largest
        channel's mean gap over every compared frame (``bias_err``: the
        rounding noise of a bf16 loop averages out of it, a systematic
        error does not), and the utterances whose length differs or that
        are missing (``len_mismatch``)."""
        pr = Precision("stated")
        name = self.mix["answer"]
        worst, mismatch = 0.0, 0
        gaps, refs_all = [], []
        for i, answer in (answers or self.sample()).items():
            refs = self.reference(i, pr)
            mismatch += abs(len(answer) - len(refs))
            for got, (ref, (a, b)) in zip(answer, refs):
                ref = ref.detach().float().cpu().numpy()
                if got.shape != ref.shape:
                    mismatch += 1
                    continue
                g = np.asarray(got[a:b], np.float64)
                r = np.asarray(ref[a:b], np.float64)
                rms = np.sqrt(np.mean(r ** 2)) + 1e-12
                worst = max(worst, float(np.max(np.abs(g - r))) / rms)
                gaps.append(g - r)
                refs_all.append(r)
        out = {f"{name}_max_err": worst, "len_mismatch": float(mismatch)}
        if gaps:
            e, r = np.concatenate(gaps), np.concatenate(refs_all)
            rms = np.sqrt(np.mean(r ** 2)) + 1e-30
            out[f"{name}_rms_err"] = float(np.sqrt(np.mean(e ** 2)) / rms)
            out[f"{name}_bias_err"] = float(
                np.max(np.abs(np.atleast_1d(e.mean(axis=0)))) / rms)
        return out
