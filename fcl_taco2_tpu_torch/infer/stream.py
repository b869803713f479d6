"""Streaming text -> wav TTS: incremental mel decode + stateful vocoder
(port of ``fcl_taco2_tpu/infer/stream.py``).

Phoneme segments decode independently (FCL's frame-level parallelism), so
mel is produced in phoneme chunks, and the streaming vocoder
(``vocoder/pwg_cuda.pwg_stream_step``) carries its ring state across
calls, so audio leaves the device a fixed ``delay`` samples (~139 ms at
22.05 kHz) behind the first decoded frame.

Pipeline (host-driven; on the card each stage is a CUDA graph, one per
static shape, as JAX jits each stage, ``stream.py:134-139``):

    frontend (whole text)                -> hs, durations      [1 readback]
    per chunk of ``chunk_phonemes``:
      decode_segments -> scatter into a device mel buffer      (exact: FCL)
      postnet over ``postnet_chunk``-frame windows with +-ctx_post frames
        of context; a per-window seq_mask reproduces the full graph's
        per-layer masking                                      (exact)
      upsample ``vocode_frames``-frame windows with +-cu frames of
        context, re-masked after every stage                   (exact)
      pwg_stream_step over Vh = vocode_frames * hop samples    (exact)

With dropout 0 the joined chunks equal ``synthesize`` + ``pwg_generate``
over the whole utterance (fp reassociation only).

The stages take the chunk's position (the vocoder step ``j``, the
postnet window ``p0``, the frame count ``F``) as device scalars, slice
their windows at device offsets and pass the vocoder its stream position
as a device tensor, so a replay runs at the position written before it;
the decode's kernel seed and the vocoder noise are drawn inside the
stages from the stream's generator, in the host's fixed order, so a
graphed stream and an eager one draw the same bits.  Every decoder route
is graphed (the scan's loop runs to the static step count).
"""

import copy

import numpy as np
import torch

from fcl_taco2_tpu_torch.models.decoder import apply_postnet_inference
from fcl_taco2_tpu_torch.ops.conv import conv1d
from fcl_taco2_tpu_torch.ops.decoder_cuda import (maybe_prequantize,
                                                  tile_step_bounds)
from fcl_taco2_tpu_torch.utils.cuda_build import make_generator
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.graphs import Graphed
from fcl_taco2_tpu_torch.vocoder.pwg import PWGConfig, _smooth
from fcl_taco2_tpu_torch.vocoder.pwg_cuda import (_round8, pack_pwg_weights,
                                                  pwg_stream_state,
                                                  pwg_stream_step,
                                                  total_delay)


def _round_up(x, m):
    return -(-x // m) * m


class StreamTTS:
    """Chunked streaming synthesis for ONE utterance at a time (B=1).

    Args:
        model: a ``Tacotron2SA`` (moved to ``device``, cast to its compute
            dtype once here).
        pwg: a ``ParallelWaveGAN``; ``pwg_cfg`` defaults to ``pwg.cfg``.
        chunk_phonemes: phoneme segments decoded per step.
        postnet_chunk: frames refined per postnet window.
        vocode_frames: mel frames consumed per vocoder call; the call
            emits ``vocode_frames * hop`` samples, a multiple of ``tile``.
        tile: the Pallas sample tile (the plain version's; the kernel
            picks its own).
        readback_depth: wav chunks whose copy to the host may lag their
            dispatch.
        device: the card unless ``device="cpu"``.
    """

    def __init__(self, model, pwg, pwg_cfg: PWGConfig = None,
                 chunk_phonemes: int = 16, postnet_chunk: int = 64,
                 vocode_frames: int = 16, tile: int = 1024,
                 budget_round: int = 256, decoder_backend: str = "auto",
                 readback_depth: int = 1, quantize: str = "none",
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).compute_model()
        self.cfg = self.model.cfg
        self.pwg_cfg = pwg_cfg or pwg.cfg
        self.pwg = copy.deepcopy(pwg).to(self.device, torch.float32)
        self.packed = pack_pwg_weights(self.pwg, self.pwg_cfg)
        self.Pc = int(chunk_phonemes)
        self.Fc = int(postnet_chunk)
        self.Fv = int(vocode_frames)
        self.hop = self.pwg_cfg.hop
        self.Vh = self.Fv * self.hop
        # small-hop configs (tests, compact vocoders) get a whole-call tile
        self.tile = min(int(tile), self.Vh)
        if self.Vh % self.tile:
            raise ValueError(
                f"vocode_frames*hop ({self.Vh}) must be a multiple of "
                f"tile ({self.tile})")
        self.delay = _round8(total_delay(self.pwg_cfg))
        self.decoder_backend = decoder_backend
        # int8 codes prepared once (inline quantization would re-read the
        # decoder weights on every chunk)
        self.quantize = quantize
        self.prequant = None
        if decoder_backend in ("auto", "pallas_hbm", "hybrid"):
            self.prequant = maybe_prequantize(
                self.cfg, self.model.decoder.jax_layout(), quantize)
        self.budget_round = int(budget_round)
        self.readback_depth = max(0, int(readback_depth))
        # context margins (frames): postnet receptive field, and the
        # upsampler's (conv_in +-aux_context_window, then each smoothing
        # conv adds < 1 frame at the final rate)
        cfgm = self.cfg
        self.ctx_post = cfgm.postnet_layers * (cfgm.postnet_filts // 2)
        self.cu = (self.pwg_cfg.aux_context_window
                   + len(self.pwg_cfg.upsample_scales) + 1)
        # leading zero margin shared by all windows; the trailing margin
        # also covers the vocoder tail (delay/hop frames past F)
        self.pad = _round_up(max(self.ctx_post, self.cu, 1), 8)
        self.tail = _round_up(
            self.pad + -(-self.delay // self.hop) + self.Fv + self.Fc, 8)
        stages = {"frontend": self._frontend,
                  "decode": self._decode_chunk,
                  "postnet": self._postnet_chunk,
                  "vocode": self._vocode_step}
        self.graphs = {k: Graphed(fn, self.device, f"stream.{k}")
                       for k, fn in stages.items()}
        self.eager = set() if self.device.type == "cuda" else set(stages)

    def _stage(self, name, inputs, gen):
        """Run a stage: a graph replay on the card, eagerly otherwise."""
        g = self.graphs[name]
        if name in self.eager:
            return g.fn(inputs, gen)
        return g(None, inputs, gen)

    # ---------------- stages ----------------

    def _frontend(self, inputs, gen):
        tokens, ilens, durations, d_factor = inputs
        hs, d_outs, _, _ = self.model.synth_frontend(
            tokens, ilens, durations=durations, d_factor=d_factor)
        return hs, d_outs

    def _decode_chunk(self, inputs, gen):
        """AR-decode Pc phoneme segments and scatter them into ``mel_buf``
        (Lbuf + 1, odim), whose last row is the drop slot."""
        hs, tok_idx, dur, position, mask, seg_start, mel_buf = inputs
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        enc_seg = hs[0][tok_idx]
        # ragged bounds: the chunk's AR loop stops at its true max duration
        seg_out = self.model.decode_segments(
            enc_seg, dur, position.to(dtype), mask, gen,
            decoder_backend=self.decoder_backend,
            tile_bounds=tile_step_bounds(dur), step_bound=dur.max(),
            quantize=self.quantize, prequant=self.prequant)
        D = mask.shape[1]
        frame_pos = seg_start[:, None] + torch.arange(
            D, dtype=torch.int32, device=mel_buf.device)
        Lbuf = mel_buf.shape[0] - 1
        tgt = torch.where(mask, self.pad + frame_pos, Lbuf)
        tgt = torch.where(tgt < Lbuf, tgt, Lbuf).reshape(-1)
        # a scatter of fixed shape: dropped frames land in the drop slot,
        # which is zeroed again
        mel_buf.index_copy_(0, tgt.long(), seg_out.reshape(-1, cfg.odim).to(
            mel_buf.dtype))
        mel_buf[Lbuf] = 0
        return mel_buf

    def _postnet_chunk(self, inputs, gen):
        """Refine frames [p0, p0 + Fc) given +-ctx_post frames of context;
        the per-window seq_mask (0 <= pos < F) makes the window's center
        equal the whole-utterance postnet.  ``p0`` and ``F_``: device
        scalars."""
        mel_buf, after_buf, p0, F_ = inputs
        cfg = self.cfg
        ctx, Fc = self.ctx_post, self.Fc
        rows = torch.arange(Fc + 2 * ctx, device=mel_buf.device)
        win = mel_buf[self.pad + p0 - ctx + rows]
        gpos = p0 - ctx + rows
        mask = (gpos >= 0) & (gpos < F_)
        after = apply_postnet_inference(self.model.decoder, cfg, win[None],
                                        seq_mask=mask[None])
        after = after * mask[None, :, None].to(after.dtype)
        after_buf[self.pad + p0 + rows[:Fc]] = after[0, ctx:ctx + Fc].float()
        return after_buf

    def _upsample_window(self, win, f0, F_):
        """Windowed ConvInUpsampleNetwork, exact against the full graph.

        ``win`` holds frames [f0 - cu, f0 - cu + Fw); each stage re-masks
        to its valid range [0, F * rate), the full graph's 'same' zero
        padding at every stage (all upsample convs are bias-free)."""
        pwg = self.pwg_cfg
        Fw = win.shape[0]
        lo = f0 - self.cu
        x = conv1d(win[None], self.pwg.upsample_net.conv_in.weight)
        gpos = lo + torch.arange(Fw, device=self.device)
        x = x * ((gpos >= 0) & (gpos < F_))[None, :, None].to(x.dtype)
        rate = 1
        for scale, taps in zip(pwg.upsample_scales,
                               self.pwg.smoothing_taps()):
            x = _smooth(x.repeat_interleave(scale, dim=1), taps)
            rate *= scale
            gpos = lo * rate + torch.arange(Fw * rate, device=self.device)
            x = x * ((gpos >= 0) & (gpos < F_ * rate))[None, :, None].to(
                x.dtype)
        return x  # (1, Fw * hop, A)

    def _vocode_step(self, inputs, gen):
        """One ``pwg_stream_step`` over samples [j * Vh, (j + 1) * Vh);
        ``j`` and ``F_`` are device scalars, the noise is drawn from
        ``gen`` unless given (as JAX's ``_vocode_step`` and
        ``_vocode_step_noise``)."""
        vstate, after_buf, j, F_, noise = inputs
        f0 = j * self.Fv
        rows = torch.arange(self.Fv + 2 * self.cu, device=after_buf.device)
        win = after_buf[self.pad + f0 - self.cu + rows]
        aux = self._upsample_window(win, f0, F_)
        aux = aux[:, self.cu * self.hop:self.cu * self.hop + self.Vh]
        if noise is None:
            noise = torch.randn(1, self.Vh, generator=gen, device=gen.device)
        pos = torch.stack([f0 * self.hop, F_ * self.hop]).to(torch.int32)
        return pwg_stream_step(self.packed, self.pwg_cfg, vstate,
                               aux.contiguous(), noise, pos, tile=self.tile)

    def _readback(self, wav):
        """Start the wav's copy to the host: into pinned memory with an
        event on the card, so the copy overlaps the next steps."""
        if not wav.is_cuda:
            return wav, None
        host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
        host.copy_(wav, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ---------------- host-driven stream ----------------

    @torch.no_grad()
    def stream(self, tokens, rng, d_factor: float = 1.0, durations=None,
               noise=None):
        """Generator: yields fp32 wav chunks (np.ndarray) as synthesized.

        Args:
            tokens: (T,) int token ids (no padding).
            rng: int seed or ``torch.Generator`` (prenet dropout and the
                vocoder noise).
            durations: optional (T,) int ground-truth durations.
            noise: optional (>= F*hop,) fp32 vocoder noise (tests,
                reproducibility); default iid normal drawn on the device.

        Total yielded samples = sum(durations) * hop.
        """
        cfg = self.cfg
        dev = self.device
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        T = tokens.shape[0]
        Tb = _round_up(max(T, 1), 8)
        tok_pad = np.zeros((1, Tb), np.int64)
        tok_pad[0, :T] = tokens
        ilens = torch.tensor([T], device=dev)
        # one generator for the whole stream: the decode chunks draw their
        # kernel seeds and the vocoder steps their noise from it, in order
        gen = make_generator(rng, dev)
        dur_t = None
        if durations is not None:
            dur_pad = np.zeros((1, Tb), np.int32)
            dur_pad[0, :T] = np.asarray(durations, np.int32)
            dur_t = torch.from_numpy(dur_pad).to(dev)
        hs, d_outs = self._stage("frontend", (
            torch.from_numpy(tok_pad).to(dev), ilens, dur_t,
            torch.tensor(float(d_factor), dtype=torch.float32, device=dev)),
            gen)
        dur = d_outs[0, :T].cpu().numpy().astype(np.int64)  # 1 small D2H
        F_ = int(dur.sum())
        if F_ == 0:
            return
        D = cfg.max_dur
        Pc, Fc, Fv = self.Pc, self.Fc, self.Fv
        budget = _round_up(F_, self.budget_round)
        Lbuf = self.pad + budget + self.tail
        dtype = getattr(torch, cfg.compute_dtype)
        mel_buf = torch.zeros(Lbuf + 1, cfg.odim, dtype=dtype, device=dev)
        after_buf = torch.zeros(Lbuf, cfg.odim, device=dev)
        vstate = pwg_stream_state(self.pwg_cfg, 1, device=dev)

        starts = np.concatenate([[0], np.cumsum(dur)])[:-1]
        Wtot = F_ * self.hop
        F_dev = torch.tensor(F_, device=dev)
        n_chunks = -(-T // Pc)
        n_vsteps = -(-(Wtot + self.delay) // self.Vh)
        if noise is not None:
            noise = np.asarray(noise, np.float32).reshape(-1)
            if noise.shape[0] < Wtot:
                raise ValueError(
                    f"noise has {noise.shape[0]} samples < F*hop={Wtot}")
            noise = torch.from_numpy(np.pad(
                noise[:Wtot], (0, n_vsteps * self.Vh - Wtot))).to(dev)

        posted = 0    # frames through the postnet
        j = 0         # vocoder step index
        pending = []  # (step, host wav, event): copies still in flight
        d_range = np.arange(D, dtype=np.int32)[None, :]

        def vocode_ready():
            return (j < n_vsteps
                    and ((j + 1) * Fv + self.cu <= posted or posted >= F_))

        def run_vocode(vstate):
            nz = None if noise is None else \
                noise[j * self.Vh:(j + 1) * self.Vh][None]
            wav, vstate = self._stage("vocode", (
                vstate, after_buf, torch.tensor(j, device=dev), F_dev, nz),
                gen)
            return self._readback(wav), vstate

        def emit(jj, wav, event):
            if event is not None:
                event.synchronize()
            lo = max(jj * self.Vh, self.delay)
            hi = min((jj + 1) * self.Vh, self.delay + Wtot)
            if hi > lo:
                return wav.numpy()[0, lo - jj * self.Vh:hi - jj * self.Vh]
            return None

        def drain(keep):
            while len(pending) > keep:
                out = emit(*pending.pop(0))
                if out is not None and out.size:
                    yield out

        for k in range(n_chunks):
            idx = np.arange(k * Pc, (k + 1) * Pc)
            valid = idx < T
            idx_c = np.where(valid, np.minimum(idx, T - 1), 0)
            dur_c = np.where(valid, dur[idx_c], 0).astype(np.int32)
            st_c = np.where(valid, starts[idx_c], 0).astype(np.int32)
            mask_c = d_range < dur_c[:, None]
            pos_c = np.where(
                mask_c, d_range.astype(np.float32)
                / np.maximum(dur_c[:, None], 1).astype(np.float32), 0.0)
            mel_buf = self._stage("decode", (
                hs, torch.from_numpy(idx_c).to(dev),
                torch.from_numpy(dur_c).to(dev),
                torch.from_numpy(pos_c).to(dev),
                torch.from_numpy(mask_c).to(dev),
                torch.from_numpy(st_c).to(dev), mel_buf), gen)
            dec_f = F_ if k == n_chunks - 1 else int(
                dur[:min((k + 1) * Pc, T)].sum())
            # the postnet window needs ctx_post future frames; at stream
            # end everything past F is masked, so no wait is needed
            while (posted + Fc + self.ctx_post <= dec_f
                   or (dec_f >= F_ and posted < F_)):
                after_buf = self._stage("postnet", (
                    mel_buf, after_buf, torch.tensor(posted, device=dev),
                    F_dev), gen)
                posted += Fc
            while vocode_ready():
                (wav, event), vstate = run_vocode(vstate)
                pending.append((j, wav, event))
                j += 1
                yield from drain(self.readback_depth)
        while j < n_vsteps:
            (wav, event), vstate = run_vocode(vstate)
            pending.append((j, wav, event))
            j += 1
            yield from drain(self.readback_depth)
        yield from drain(0)

    def tts(self, tokens, rng, **kw):
        """Run the stream to completion; returns (F*hop,) fp32."""
        chunks = list(self.stream(tokens, rng, **kw))
        if not chunks:
            return np.zeros((0,), np.float32)
        return np.concatenate(chunks)
