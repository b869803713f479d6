"""Text -> wav through ``TTSPipeline.tts_batch`` (``infer/pipeline.py``):
the acoustic model and the Parallel WaveGAN vocoder, one call a request,
the durations given (``durations=``, d_factor 1), ``frame_per_token``
frames of budget a token and the whole budget vocoded, as the pipeline
does.  The answer is each utterance's wav on the host; the reference
draws the call's noise and then the dropout's seed from a generator
seeded as the call's, in that order, as the pipeline's documented
contract draws them, and compares the samples the utterance's own frames
determine: all but the vocoder's one-sided receptive field at each end,
where the result depends on how the program pads the utterance's edges
(zeros on the card, the chunked path's static pads on the CPU) and on
how much of the frame budget it vocodes.
"""

import numpy as np
import torch

from benchmark import weights
from benchmark.drivers.common import ClosedLoop, _ceil
from benchmark.reference import pwg as ref_pwg
from benchmark.reference import taco2 as ref_taco2


def pad_batch(utts, tok_bucket, device):
    """(tokens, ilens, durations) of ``utts`` padded to a multiple of
    ``tok_bucket`` tokens, as tensors on ``device``."""
    T = _ceil(max(len(u.tokens) for u in utts), tok_bucket) * tok_bucket
    tokens = np.zeros((len(utts), T), np.int64)
    durs = np.zeros((len(utts), T), np.int32)
    for b, u in enumerate(utts):
        tokens[b, :len(u.tokens)] = u.tokens
        durs[b, :len(u.tokens)] = u.durations
    ilens = np.array([len(u.tokens) for u in utts], np.int64)
    return (torch.from_numpy(tokens).to(device),
            torch.from_numpy(ilens).to(device),
            torch.from_numpy(durs).to(device))


class Driver(ClosedLoop):
    def build(self):
        from fcl_taco2_tpu_torch.infer.pipeline import TTSPipeline
        from fcl_taco2_tpu_torch.models import ModelConfig, Tacotron2SA
        from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN,
                                                     PWGConfig)
        c = self.config
        serve = getattr(torch, c["precision"]["compute_dtype"])
        model = Tacotron2SA(ModelConfig(**c["model"]), device=self.device)
        self.sd = weights.seeded_state(model, self.seed, self.device,
                                       round_to=serve, tag="model")
        model.load_state_dict(self.sd)
        vc = dict(c["vocoder"])
        pwg = ParallelWaveGAN(PWGConfig(**{
            **vc, "upsample_scales": tuple(vc["upsample_scales"])}),
            device=self.device)
        # the pipeline serves the vocoder's weights rounded to this type
        vin = getattr(torch, c["precision"]["vocoder_inputs"])
        self.vsd = weights.seeded_state(pwg, self.seed, self.device,
                                        round_to=vin, tag="vocoder")
        pwg.load_state_dict(self.vsd)
        self.pipe = TTSPipeline(
            model, pwg, sample_rate=c["sample_rate"],
            pwg_dtype=c["precision"]["vocoder_inputs"], device=self.device)

    def call(self, i):
        utts, seed = self.calls[i]
        wavs, _ = self.pipe.tts_batch(
            [u.tokens for u in utts], seed,
            frame_per_token=self.mix["frame_per_token"],
            durations=[u.durations for u in utts])
        return wavs

    def graphs(self):
        return self.pipe.graphs

    def free(self):
        del self.pipe

    def reference(self, i, pr):
        utts, seed = self.calls[i]
        c, m, dev = self.config, self.mix, self.device
        vc = c["vocoder"]
        hop = ref_pwg.hop(vc)
        tokens, ilens, durs = pad_batch(utts, m["tok_bucket"], dev)
        budget = _ceil(tokens.shape[1] * m["frame_per_token"],
                       m["frame_bucket"]) * m["frame_bucket"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        noise = torch.randn(len(utts), budget * hop, generator=gen,
                            device=dev)
        dseed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                  device=dev))
        mel, olens = ref_taco2.synthesize(
            self.sd, c["model"], tokens, ilens, durs, dseed, pr,
            getattr(torch, c["precision"]["decoder_loop"]))
        full = mel.new_zeros(len(utts), budget, mel.shape[2])
        full[:, :mel.shape[1]] = mel
        vin = getattr(torch, c["precision"]["vocoder_inputs"])
        wav = ref_pwg.generate(self.vsd, vc, full.to(vin).float(),
                               noise.to(vin).float(), pr)
        edge = ref_pwg.receptive_field(vc)
        return [(wav[b, :int(olens[b]) * hop],
                 (edge, max(int(olens[b]) * hop - edge, edge)))
                for b in range(len(utts))]
