"""Text -> mel through ``Synthesizer.synth_batch`` (``infer/synth.py``)
serving Tacotron2 with location-sensitive attention
(``models/tacotron2.py``): ``batch`` utterances a call, each one's frames
pinned to the sum of its durations (``lengths=``, espnet's minlen =
maxlen); each call's mels are on the host before the next call.  The
answer is each utterance's mel, with its stop logits beside it
(``Answer.stop``); the reference (``reference/tacotron2.py``, one
utterance at a time) draws the dropout's seed from a generator seeded as
the call's, as the entry's documented contract draws it, and compares
every frame and every stop logit.  Besides the frames reversed, the
check's calibration plants two faults of the mathematics, the reference
computed with them put in the program's place: the location term dropped
from the energies, and the weights not accumulated.
"""

import numpy as np
import torch

from benchmark import weights
from benchmark.drivers.common import ClosedLoop
from benchmark.drivers.tts import pad_batch
from benchmark.reference import tacotron2 as ref_t2
from benchmark.reference.precision import Precision


class Answer(list):
    """One array a call's utterance (the mels), with ``stop``: their stop
    logits."""

    def __init__(self, mels, stop):
        super().__init__(mels)
        self.stop = stop


class Driver(ClosedLoop):
    def build(self):
        from fcl_taco2_tpu_torch.infer.synth import Synthesizer
        from fcl_taco2_tpu_torch.models.tacotron2 import (Tacotron2,
                                                          Tacotron2Config)
        c, m = self.config, self.mix
        serve = getattr(torch, c["precision"]["compute_dtype"])
        model = Tacotron2(Tacotron2Config(**c["model"]), device=self.device)
        self.sd = weights.seeded_state(model, self.seed, self.device,
                                       round_to=serve, tag="model")
        model.load_state_dict(self.sd)
        self.synth = Synthesizer(
            model, batch_size=m["batch"], tok_bucket=m["tok_bucket"],
            frame_bucket=m["frame_bucket"], device=self.device)
        self.ref_stops = {}

    def call(self, i):
        utts, seed = self.calls[i]
        mels, stats = self.synth.synth_batch(
            [u.tokens for u in utts], seed,
            lengths=[u.frames for u in utts])
        return Answer(mels, stats["stop"])

    def graphs(self):
        return self.synth.graphs

    def free(self):
        del self.synth

    def _reference(self, i, pr, fault=None):
        utts, seed = self.calls[i]
        c, dev = self.config, self.device
        tokens, ilens, _ = pad_batch(utts, self.mix["tok_bucket"], dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dseed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                  device=dev))
        budget = max(u.frames for u in utts)
        return ref_t2.synthesize(
            self.sd, c["model"], tokens, ilens, dseed, pr,
            getattr(torch, c["precision"]["decoder_loop"]), budget,
            lengths=[u.frames for u in utts], fault=fault)

    def reference(self, i, pr):
        rows = self._reference(i, pr)
        self.ref_stops[i] = [s.float().cpu().numpy() for _, s, _ in rows]
        return [(mel, (0, mel.shape[0])) for mel, _, _ in rows]

    def _as_answer(self, rows):
        return Answer([m.float().cpu().numpy() for m, _, _ in rows],
                      [s.float().cpu().numpy() for _, s, _ in rows])

    def control_answers(self):
        pr = Precision("control")
        return {i: self._as_answer(self._reference(i, pr))
                for i in self.sample()}

    def fault_answers(self):
        out = super().fault_answers()
        # the frames reversed leave the stop logits as the program gave them
        kept = self.sample()
        out["reversed"] = {i: Answer(a, kept[i].stop)
                           for i, a in out["reversed"].items()}
        pr = Precision("stated")
        for fault in ("no_location", "no_cumulate"):
            out[fault] = {i: self._as_answer(self._reference(i, pr, fault))
                          for i in self.sample()}
        return out

    def check(self, answers=None):
        """The mel's numbers (``ClosedLoop.check``) and, where the answers
        carry stop logits, ``stop_max_err``: the largest gap of a stop
        logit, over every compared frame."""
        answers = answers or self.sample()
        out = super().check(answers)
        gaps = [np.abs(np.asarray(g, np.float64) - r).max()
                for i, a in answers.items() if hasattr(a, "stop")
                for g, r in zip(a.stop, self.ref_stops[i])
                if len(g) == len(r) and len(r)]
        if gaps:
            out["stop_max_err"] = float(max(gaps))
        return out
