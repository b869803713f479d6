"""Batched multi-utterance synthesis with speed metrics (port of
``fcl_taco2_tpu/infer/synth.py:30-267``).

Kept: bucketed ``(B, Tmax, budget)`` shapes, the exact re-dispatch when
predicted durations overrun the frame budget, the frames/s stats and
``quantize="int8"`` with the codes prepared once at init.  The port runs
eagerly, so there is no compile cache; one device serves (no mesh).
Manifest decoding and the CLIs come with the checkpoint reader.
"""

import math
import time
from typing import List, Optional

import numpy as np
import torch

from fcl_taco2_tpu_torch.ops.decoder_cuda import maybe_prequantize
from fcl_taco2_tpu_torch.utils.device import resolve_device


def _round_up(x, mult):
    return int(math.ceil(max(x, 1) / mult) * mult)


class Synthesizer:
    def __init__(self, model, batch_size=8, tok_bucket=32,
                 frame_per_token=16, frame_bucket=256, ragged_decode=True,
                 quantize="none", decoder_backend="auto", device="cuda"):
        """``model``: a ``Tacotron2SA``; it is moved to ``device`` (the card
        unless ``device="cpu"``), and its parameters are cast to the
        config's compute dtype once here — the JAX package casts inside
        every call, to the same values.  ``quantize``: "none" | "int8"
        (streaming decoder entry only; codes prepared once here)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).compute_model()
        self.ragged_decode = bool(ragged_decode)
        self.quantize = quantize
        self.decoder_backend = decoder_backend
        self.prequant = None
        if decoder_backend in ("auto", "pallas_hbm", "hybrid"):
            self.prequant = maybe_prequantize(
                self.model.cfg, self.model.decoder.jax_layout(), quantize)
        self.batch_size = batch_size
        self.tok_bucket = tok_bucket
        self.frame_per_token = frame_per_token
        self.frame_bucket = frame_bucket

    def _run(self, tokens, ilens, durs, use_dur, gen_state, gen, budget,
             d_factor):
        gen.set_state(gen_state)  # a re-dispatch draws the same dropout
        return self.model.synthesize(
            tokens, ilens, gen, frame_budget=budget,
            durations=durs if use_dur else None, d_factor=d_factor,
            ragged_decode=self.ragged_decode, quantize=self.quantize,
            decoder_backend=self.decoder_backend, prequant=self.prequant)

    def synth_batch(self, token_lists: List[np.ndarray], rng,
                    durations: Optional[List[np.ndarray]] = None,
                    d_factor: float = 1.0):
        """Synthesize a batch of token sequences; returns (mels, stats).

        ``rng``: int seed or ``torch.Generator`` (on the model's device)
        for the prenet dropout.  mels: list of (L_i, odim) float32 numpy;
        stats: frames/s over the whole batch call (wall clock includes the
        copy back to the host)."""
        n = len(token_lists)
        B = self.batch_size
        if n > B:
            raise ValueError(f"{n} utterances > batch_size {B}")
        Tmax = _round_up(max(len(t) for t in token_lists), self.tok_bucket)
        if durations is not None:
            # exact budget from the given durations: the device's
            # per-phoneme round(d * factor) + clip, so it never truncates
            D = self.model.cfg.max_dur
            need = max(
                int(np.clip(np.round(np.asarray(d, np.float32)
                                     * np.float32(d_factor)),
                            0, D).sum())
                for d in durations)
            budget = _round_up(need, self.frame_bucket)
        else:
            budget = _round_up(
                int(math.ceil(Tmax * self.frame_per_token
                              * max(d_factor, 1.0))), self.frame_bucket)
        tokens = np.zeros((B, Tmax), np.int64)
        ilens = np.zeros(B, np.int64)
        durs = np.zeros((B, Tmax), np.int32)
        for i, t in enumerate(token_lists):
            tokens[i, :len(t)] = t
            ilens[i] = len(t)
            if durations is not None:
                durs[i, :len(t)] = durations[i]
        dev = self.device
        args = (torch.from_numpy(tokens).to(dev),
                torch.from_numpy(ilens).to(dev),
                torch.from_numpy(durs).to(dev), durations is not None)
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(rng))
        gen_state = gen.get_state()

        t0 = time.perf_counter()
        out = self._run(*args, gen_state, gen, budget, d_factor)
        mel = out["mel"].cpu().numpy()  # waits for the device
        olens = out["olens"].cpu().numpy()
        wall = time.perf_counter() - t0

        # never return truncated mels: when predicted durations overrun
        # the heuristic budget, the exact need is known from d_outs, so
        # re-dispatch once at the exact bucket
        redispatched = 0
        while durations is None and int((olens[:n] >= budget).sum()):
            need = int(out["d_outs"][:n].sum(dim=1).max())
            new_budget = _round_up(need, self.frame_bucket)
            if new_budget <= budget:
                break  # budget boundary hit exactly; nothing was dropped
            budget = new_budget
            redispatched += 1
            t0 = time.perf_counter()
            out = self._run(*args, gen_state, gen, budget, d_factor)
            mel = out["mel"].cpu().numpy()
            olens = out["olens"].cpu().numpy()
            wall = time.perf_counter() - t0

        mels = [mel[i, :olens[i]] for i in range(n)]
        total_frames = int(olens[:n].sum())
        fps = total_frames / wall if wall > 0 else float("inf")
        return mels, {"frames_per_sec": fps, "wall_sec": wall,
                      "total_frames": total_frames, "truncated": 0,
                      "redispatched": redispatched, "budget": budget}
