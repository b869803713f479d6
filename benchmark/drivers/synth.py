"""Text -> mel through ``Synthesizer.synth_batch`` (``infer/synth.py``):
``batch`` utterances a call with their durations given, ragged decode,
``decoder_backend`` as the mix states; each call's mels are on the host
before the next call.  The answer is each utterance's mel; the reference
draws the dropout's seed from a generator seeded as the call's, as the
entry's documented contract draws it, and compares every frame.
"""

import torch

from benchmark import weights
from benchmark.drivers.common import ClosedLoop
from benchmark.drivers.tts import pad_batch
from benchmark.reference import taco2 as ref_taco2


class Driver(ClosedLoop):
    def build(self):
        from fcl_taco2_tpu_torch.infer.synth import Synthesizer
        from fcl_taco2_tpu_torch.models import ModelConfig, Tacotron2SA
        c, m = self.config, self.mix
        serve = getattr(torch, c["precision"]["compute_dtype"])
        model = Tacotron2SA(ModelConfig(**c["model"]), device=self.device)
        self.sd = weights.seeded_state(model, self.seed, self.device,
                                       round_to=serve, tag="model")
        model.load_state_dict(self.sd)
        self.synth = Synthesizer(
            model, batch_size=m["batch"], tok_bucket=m["tok_bucket"],
            frame_bucket=m["frame_bucket"], ragged_decode=True,
            quantize=self.options.get("quantize", "none"),
            decoder_backend=m["decoder_backend"], device=self.device)

    def call(self, i):
        utts, seed = self.calls[i]
        mels, _ = self.synth.synth_batch(
            [u.tokens for u in utts], seed,
            durations=[u.durations for u in utts])
        return mels

    def graphs(self):
        return self.synth.graphs

    def free(self):
        del self.synth

    def reference(self, i, pr):
        utts, seed = self.calls[i]
        c, dev = self.config, self.device
        tokens, ilens, durs = pad_batch(utts, self.mix["tok_bucket"], dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dseed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                  device=dev))
        mel, olens = ref_taco2.synthesize(
            self.sd, c["model"], tokens, ilens, durs, dseed, pr,
            getattr(torch, c["precision"]["decoder_loop"]))
        return [(mel[b, :int(olens[b])], (0, int(olens[b])))
                for b in range(len(utts))]
