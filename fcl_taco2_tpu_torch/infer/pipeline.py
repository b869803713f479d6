"""End-to-end TTS: phonemes -> mel (FCL-taco2) -> wav (Parallel WaveGAN)
(port of ``fcl_taco2_tpu/infer/pipeline.py``).

``TTSPipeline.tts_batch`` runs synthesize and the vocoder as one device
pipeline; on the card the vocoder is the streaming kernel
(``vocoder/pwg_cuda.py``), and the decode's draws, the noise draw and
``synth_vocode`` (the body of JAX's jitted ``fn``, pipeline.py:58-84) are
one CUDA graph per ``(B, Tmax, budget)`` (``utils/graphs.py``), captured
by the call's untimed warm-up.  ``vocode_chunked`` vocodes a mel stream in
chunks with receptive-field context, edge-exact against the whole
utterance; on the card each chunk shape is one CUDA graph, as JAX jits
its ``pwg_generate`` (pipeline.py:127).

Spans (``utils/spans.py``): the vocoder's call is ``serve.vocoder`` (the
model's own are ``Tacotron2SA.synthesize``'s); ``tts_batch``'s host
phases are ``serve.prepare`` (padding, the copies to the card),
``serve.launch`` (the graph's call: its input copies, the replay, the
outputs' clones) and ``serve.readback`` (the copy to the host, the
per-utterance slices).
"""

import copy
import time
from typing import List, Optional

import numpy as np
import torch

from fcl_taco2_tpu_torch.ops.decoder_cuda import maybe_prequantize
from fcl_taco2_tpu_torch.utils.cuda_build import make_generator
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.graphs import Graphed
from fcl_taco2_tpu_torch.utils.spans import span
from fcl_taco2_tpu_torch.vocoder.pwg import PWGConfig, pwg_generate
from fcl_taco2_tpu_torch.vocoder.pwg_cuda import pack_pwg_weights, vocode


def pwg_receptive_field(cfg: PWGConfig):
    """One-sided receptive field in samples of the PWG conv stack."""
    rf = 0
    for d in cfg.dilations:
        rf += (cfg.kernel_size - 1) // 2 * d
    # upsample smoothing convs + conv_in act on the mel grid
    rf_mel = cfg.aux_context_window + sum(s for s in cfg.upsample_scales)
    return rf + rf_mel * cfg.hop


def _rounded_copy(pwg, dtype, device):
    """``pwg`` on ``device`` with every weight rounded to ``dtype`` and
    held in fp32: the values the JAX pipeline's kernel sees after it casts
    the params to ``pwg_dtype`` and upcasts them (pipeline.py:69-71)."""
    out = copy.deepcopy(pwg).to(device)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype).float())
    return out


class TTSPipeline:
    """Batched text -> wav on one device.

    Args:
        model: a ``Tacotron2SA``; moved to ``device`` and cast to its
            compute dtype once here.
        pwg: a ``ParallelWaveGAN``; ``pwg_cfg`` defaults to ``pwg.cfg``.
        pwg_dtype: the PWG weights, the mel and the noise are rounded to
            it before the fp32 vocoder runs (as the JAX pipeline does).
        quantize: "none" | "int8" decode (codes prepared once here).
        device: the card unless ``device="cpu"``.
    """

    def __init__(self, model, pwg, pwg_cfg: Optional[PWGConfig] = None,
                 sample_rate=22050, pwg_dtype="bfloat16", quantize="none",
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).compute_model()
        self.pwg_cfg = pwg_cfg or pwg.cfg
        self.pwg_dtype = getattr(torch, pwg_dtype)
        self.pwg = _rounded_copy(pwg, self.pwg_dtype, self.device)
        # the kernel's operands, packed once (as StreamTTS does)
        self.packed = pack_pwg_weights(self.pwg, self.pwg_cfg)
        self.quantize = quantize
        self.prequant = maybe_prequantize(
            self.model.cfg, self.model.decoder.jax_layout(), quantize)
        self.sample_rate = sample_rate
        self._seen = set()
        self.graphs = Graphed(self._graph_body, self.device, "tts_batch")
        self.graphed = self.device.type == "cuda"

    def synth_vocode(self, tokens, ilens, rng, budget, noise,
                     durations=None):
        """synthesize + vocode of one padded batch (the body of the JAX
        pipeline's jitted ``fn``, pipeline.py:63-81).

        tokens/ilens: (B, Tmax)/(B,) int tensors on the device; rng: int
        seed, ``torch.Generator`` or (1,) int32 seed tensor for the prenet
        dropout (``Tacotron2SA.synthesize``); noise:
        (B, budget * hop) float; durations: optional (B, Tmax) int.
        Returns (wav (B, budget * hop) fp32, wav_lens, olens)."""
        hop = self.pwg_cfg.hop
        out = self.model.synthesize(tokens, ilens, rng, frame_budget=budget,
                                    durations=durations,
                                    quantize=self.quantize,
                                    prequant=self.prequant)
        dt = self.pwg_dtype
        mel = out["mel"].to(dt).float()
        noise = noise.to(self.device).to(dt).float()
        with span("serve.vocoder"):
            wav = vocode(self.pwg, self.pwg_cfg, mel, noise,
                         packed=self.packed)
        return wav.float(), out["olens"] * hop, out["olens"]

    def _graph_body(self, inputs, gen):
        """The noise draw and ``synth_vocode``, whose decode draws from
        ``gen`` after it (the kernels' seed, kept on the device, or the
        scan's prenet masks)."""
        tokens, ilens, durs, budget = inputs
        noise = torch.randn(tokens.shape[0], budget * self.pwg_cfg.hop,
                            generator=gen, device=gen.device)
        return self.synth_vocode(tokens, ilens, gen, budget, noise,
                                 durations=durs)

    def tts_batch(self, token_lists: List[np.ndarray], rng,
                  frame_per_token=16,
                  durations: Optional[List[np.ndarray]] = None):
        """Batched text->wav; returns (wavs, stats with RTF).  ``rng``: int
        seed or ``torch.Generator`` on the device; the vocoder's noise and
        then the decode's dropout are drawn from it on the device.
        ``durations``: optional per-utterance frame counts (the port's
        addition, as ``Synthesizer.synth_batch`` takes them); the budget
        stays ``Tmax * frame_per_token`` and the whole budget is vocoded,
        as in the JAX pipeline."""
        with span("serve.prepare"):
            B = len(token_lists)
            Tmax = max(len(t) for t in token_lists)
            Tmax = (Tmax + 15) // 16 * 16
            budget = ((Tmax * frame_per_token) + 255) // 256 * 256
            tokens = np.zeros((B, Tmax), np.int64)
            ilens = np.zeros(B, np.int64)
            durs = np.zeros((B, Tmax), np.int32)
            for i, t in enumerate(token_lists):
                tokens[i, :len(t)] = t
                ilens[i] = len(t)
                if durations is not None:
                    durs[i, :len(t)] = durations[i]
            dev = self.device
            tokens = torch.from_numpy(tokens).to(dev)
            ilens = torch.from_numpy(ilens).to(dev)
            durs = None if durations is None \
                else torch.from_numpy(durs).to(dev)
            gen = make_generator(rng, dev)
            state = gen.get_state()
            inputs = (tokens, ilens, durs, budget)

        def run():
            gen.set_state(state)  # the warm-up and the timed call agree
            if self.graphed:
                return self.graphs(None, inputs, gen)
            return self._graph_body(inputs, gen)

        key = (B, Tmax, budget)
        if key not in self._seen:  # one-time set-up (the kernels' build,
            # library handles) stays out of the RTF, as the JAX pipeline
            # keeps its compile out
            self._seen.add(key)
            run()
        t0 = time.perf_counter()
        with span("serve.launch"):
            wav, wav_lens, olens = run()
        with span("serve.readback"):
            wav = wav.cpu().numpy()  # waits for the device
            wav_lens = wav_lens.cpu().numpy()
            wall = time.perf_counter() - t0
            wavs = [wav[i, :wav_lens[i]] for i in range(B)]
        audio_sec = float(wav_lens.sum()) / self.sample_rate
        return wavs, {"wall_sec": wall, "audio_sec": audio_sec,
                      "rtf_x": audio_sec / wall if wall > 0 else float("inf"),
                      "frames": int(olens.sum())}


@torch.no_grad()
def vocode_chunked(pwg, pwg_cfg: PWGConfig, mel, noise, chunk_frames=64,
                   context_frames=None, graphed=True):
    """Vocode a (T, n_mels) mel in chunks with receptive-field context.

    Yields wav chunks of chunk_frames*hop samples (numpy); concatenated
    output matches full-utterance vocoding in the interior of each chunk.
    ``mel`` and ``noise`` are numpy or tensors; they run on ``pwg``'s
    device.  On the card each chunk shape is one CUDA graph of
    ``pwg_generate`` (the interior chunks share one), made for the call as
    JAX jits it for the call (pipeline.py:127); ``graphed=False`` runs the
    chunks eagerly."""
    hop = pwg_cfg.hop
    if context_frames is None:
        context_frames = -(-pwg_receptive_field(pwg_cfg) // hop) + 1
    dev = pwg.device
    mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    graphs = Graphed(lambda x, _: pwg_generate(pwg, pwg_cfg, x[0], x[1]),
                     dev, "vocode_chunked")
    T = mel.shape[0]
    for start in range(0, T, chunk_frames):
        end = min(start + chunk_frames, T)
        a = max(0, start - context_frames)
        b = min(T, end + context_frames)
        inputs = (mel[a:b][None], noise[a * hop:b * hop][None])
        wav = (graphs(None, inputs) if graphed
               else graphs.fn(inputs, None))[0]
        yield wav[(start - a) * hop:(end - a) * hop].cpu().numpy()
