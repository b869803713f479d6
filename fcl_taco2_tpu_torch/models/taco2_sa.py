"""FCL-taco2 model assembly: encoder + variance adaptor + SA decoder +
losses (port of ``fcl_taco2_tpu/models/taco2_sa.py``).

``Tacotron2SA`` holds the parameters as ``nn.Module``s on one device.
``loss_fn`` is the training forward (five loss terms, fp32 losses, the
bf16 policy as a differentiable cast of the fp32 masters).
``synthesize`` keeps the JAX package's device-side plan: durations become
the segment plan with cumsums and gathers, segments are sorted by
duration for the ragged decode, and frames are scattered back into
per-utterance timelines; nothing loops over phonemes on the host.
"""

import copy
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from fcl_taco2_tpu_torch.models import components as C
from fcl_taco2_tpu_torch.models.decoder import (
    Decoder, apply_postnet_inference, decoder_inference,
    decoder_teacher_forced, decoder_teacher_forced_classed)
from fcl_taco2_tpu_torch.models.encoder import Encoder, encoder_apply
from fcl_taco2_tpu_torch.ops import decoder_cuda as K
from fcl_taco2_tpu_torch.ops.masking import (N_UTTS, N_VALID, TOKENS,
                                             count_frames,
                                             lengths_to_non_pad_mask,
                                             lengths_to_pad_mask, masked_l1,
                                             masked_mse, weighted_l1,
                                             weighted_mse)
from fcl_taco2_tpu_torch.ops.regroup import (gather_segments,
                                             gather_token_vectors)
from fcl_taco2_tpu_torch.utils.cuda_build import (cached_pack, kernel_seed,
                                                  make_generator)
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.initializers import init_tacotron2sa_
from fcl_taco2_tpu_torch.utils.spans import span


def _concat_spemb(hs, spembs):
    """L2-normalize the speaker vector and concat per token
    (``taco2_sa.py:33-42``)."""
    norm = spembs / torch.clamp(spembs.norm(dim=-1, keepdim=True), min=1e-12)
    norm = norm.to(hs.dtype)
    return torch.cat([hs, norm[:, None, :].expand(hs.shape[0], hs.shape[1],
                                                  norm.shape[-1])], dim=-1)


def _cast_floats(model, dtype):
    """The model with float PARAMETERS in ``dtype`` (``taco2_sa.py:45-53``:
    the JAX state tree, here the BatchNorm running statistics, stays
    fp32).  Returns ``model`` itself when nothing needs a cast."""
    if all(p.dtype == dtype for p in model.parameters()
           if p.is_floating_point()):
        return model
    cast = copy.deepcopy(model)
    cast.__dict__.pop("_packs", None)  # packed for the original weights
    for p in cast.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return cast


class SegClass(NamedTuple):
    """One duration class's segment plan (``taco2_sa.py:56-65``)."""

    seg_utt: Any       # (P_c,)
    seg_tok: Any       # (P_c,)
    seg_start: Any     # (P_c,)
    frame_mask: Any    # (P_c, D_c) bool
    position: Any      # (P_c, D_c) float32


class Batch(NamedTuple):
    """One training batch with static-bucketed shapes (``taco2_sa.py:68-90``;
    ``data/converter.py`` makes it in numpy, ``data/loader.py`` moves it to
    the device).  With duration classes the flat seg_* / frame_mask /
    position fields are None and ``seg_classes`` carries the per-class
    plans.  ``counts`` is set on a rank's share of a data-parallel batch
    only; the losses then divide by the global batch's counts."""

    tokens: Any        # (B, Tmax) int32, PAD=0
    ilens: Any         # (B,)
    mel: Any           # (B, Lmax, odim)
    olens: Any         # (B,)
    durations: Any     # (B, Tmax) int32 frames per token
    f0: Any            # (B, Tmax, 1)
    energy: Any        # (B, Tmax, 1)
    seg_utt: Any       # (P,)
    seg_tok: Any       # (P,)
    seg_start: Any     # (P,)
    frame_mask: Any    # (P, D) bool
    position: Any      # (P, D) float32
    utt_gather: Any    # (B, Lmax) int32
    utt_mask: Any      # (B, Lmax) bool
    spembs: Any = None  # optional (B, spk_embed_dim)
    seg_classes: Any = None  # optional tuple of SegClass
    # a rank's share of a global batch: the global batch's denominators
    # (ops/masking.py::global_counts, one float32 vector;
    # parallel/distributed.py)
    counts: Any = None


def _cast_batch(batch, dtype):
    """The batch's float inputs in the compute dtype
    (``taco2_sa.py:183-195``)."""
    def cast(x):
        return None if x is None else x.to(dtype)
    return batch._replace(
        mel=cast(batch.mel), f0=cast(batch.f0), energy=cast(batch.energy),
        position=cast(batch.position), spembs=cast(batch.spembs),
        seg_classes=None if batch.seg_classes is None else tuple(
            sc._replace(position=cast(sc.position))
            for sc in batch.seg_classes))


def scatter_to_timelines(seg_out, frame_mask, seg_utt, seg_start, B,
                         frame_budget):
    """Phoneme frames (P, D, odim) -> per-utterance timelines (B,
    frame_budget, odim).  Frames past the budget or past their phoneme's
    duration go to one spare row, sliced off: a scatter of fixed shape
    (every segment frame is written, the kept ones to distinct rows), so
    a CUDA graph captures it; equal to selecting the kept frames with a
    boolean mask."""
    D = frame_mask.shape[1]
    d_range = torch.arange(D, dtype=torch.int32, device=seg_out.device)
    frame_pos = seg_start[:, None] + d_range[None, :]
    keep = frame_mask & (frame_pos < frame_budget)
    spare = B * frame_budget
    tgt = torch.where(keep, seg_utt[:, None] * frame_budget + frame_pos,
                      spare)
    before = seg_out.new_zeros(spare + 1, seg_out.shape[-1])
    before.index_copy_(0, tgt.reshape(-1).long(),
                       seg_out.reshape(-1, seg_out.shape[-1]))
    return before[:spare].view(B, frame_budget, seg_out.shape[-1])


class Tacotron2SA(nn.Module):
    """Encoder + variance adaptor + SA decoder, inference.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path.  Parameters are drawn
    from ``seed`` with the JAX package's init distributions; load trained
    or JAX weights with ``load_state_dict(utils.params.params_from_jax(
    ...))``.
    """

    def __init__(self, cfg, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=dev)
        self.decoder = Decoder(cfg, device=dev)
        self.duration_predictor = C.VariancePredictor(
            cfg.dec_idim, cfg.duration_predictor_layers,
            cfg.duration_predictor_chans,
            cfg.duration_predictor_kernel_size, device=dev)
        if cfg.use_fe_condition:
            self.pitch_predictor = C.VariancePredictor(
                cfg.dec_idim, cfg.pitch_predictor_layers,
                cfg.pitch_predictor_chans, cfg.pitch_predictor_kernel_size,
                device=dev)
            self.energy_predictor = C.VariancePredictor(
                cfg.dec_idim, cfg.energy_predictor_layers,
                cfg.energy_predictor_chans,
                cfg.energy_predictor_kernel_size, device=dev)
            self.pitch_embed = nn.Conv1d(1, cfg.dec_idim,
                                         cfg.pitch_embed_kernel_size,
                                         device=dev)
            self.energy_embed = nn.Conv1d(1, cfg.dec_idim,
                                          cfg.energy_embed_kernel_size,
                                          device=dev)
        init_tacotron2sa_(self, torch.Generator().manual_seed(seed))
        self.eval()

    @property
    def device(self):
        return self.decoder.feat_out.weight.device

    def compute_model(self):
        """This model with its parameters in ``cfg.compute_dtype``."""
        return _cast_floats(self, getattr(torch, self.cfg.compute_dtype))

    def packed_decoder(self, idim, weights_dtype, prequant=None):
        """The decoder's AR-loop weights packed for the CUDA kernel
        (``ops.decoder_cuda.pack_decoder_weights``): made once per weight
        dtype and reused by every later call (``Synthesizer``,
        ``TTSPipeline`` and ``StreamTTS`` each hold one model) until the
        decoder's parameters or ``prequant`` change."""
        return cached_pack(
            self, weights_dtype, self.decoder.parameters(),
            lambda: K.pack_decoder_weights(self.decoder.jax_layout(), idim,
                                           weights_dtype, prequant=prequant),
            extra=(idim, None if prequant is None
                   else tuple(t.data_ptr() for t in prequant)))

    # ---------------- training forward ----------------

    def loss_fn(self, batch, generator, train=True, capture_kd=False):
        """The training loss (``taco2_sa.py:171-317``).

        Args:
            batch: a ``Batch`` of tensors on the model's device.
            generator: the step's ``torch.Generator`` on that device; every
                dropout and the zoneout masks draw from it, in a fixed
                order and with no host-side seed, so a CUDA graph of the
                step replays fresh draws from the seed the generator holds
                at each replay.
            train: dropout, zoneout masks and BatchNorm batch statistics.
            capture_kd: also return the knowledge KD compares
                (``taco2_sa.py:303-318``).
        Returns ``(loss, (report, new_state, knowledge))``: ``report`` maps
        l1/mse/dur[/pitch/energy]_loss and loss to detached fp32 scalars;
        ``new_state`` maps BatchNorm buffer names to their new running
        statistics (train mode), which the caller writes back;
        ``knowledge`` is None, or with ``capture_kd`` a dict of
        ``after_outs``, ``before_outs``, ``encoder`` ([embed, conv0..,
        blstm]), ``decoder`` ([prenet, lstm0, lstm1, postnet layers..])
        and ``prosody`` ([d_outs[..., None], p_outs, e_outs, p_embs,
        e_embs]), in the compute dtype.

        With ``compute_dtype="bfloat16"`` the fp32 parameters are cast to
        bf16 inside the forward by a differentiable ``.to()``, so the
        gradients land in fp32 on them; losses stay fp32.
        """
        if capture_kd and self.cfg.elayers < 1:
            raise ValueError("capture_kd requires elayers >= 1 (the KD "
                             "encoder captures the BiLSTM output, "
                             "encoder_sa_kd.py:196)")
        dtype = getattr(torch, self.cfg.compute_dtype)
        if dtype == torch.float32:
            return self(batch, generator, train, capture_kd)
        params = {n: p.to(dtype) if p.is_floating_point() else p
                  for n, p in self.named_parameters()}
        return torch.func.functional_call(
            self, params, (batch, generator, train, capture_kd))

    def forward(self, batch, generator, train=True, capture_kd=False):
        """``loss_fn`` in the parameters' own dtype."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if dtype != torch.float32:
            batch = _cast_batch(batch, dtype)
        bn_enc, bn_dec = [], []
        (hs, pad_mask, d_outs, p_outs, e_outs, p_embs, e_embs,
         enc_kd) = self._encode_and_predict(batch, generator, train, bn_enc,
                                            capture_kd)
        hs_cond = hs + p_embs + e_embs if cfg.use_fe_condition else hs
        if batch.seg_classes is not None:
            class_inputs = tuple(
                (gather_token_vectors(hs_cond, sc.seg_utt, sc.seg_tok,
                                      sc.frame_mask[:, 0]),
                 gather_segments(batch.mel, sc.seg_utt, sc.seg_start,
                                 sc.frame_mask),
                 sc.position)
                for sc in batch.seg_classes)
            dec = decoder_teacher_forced_classed(
                self.decoder, cfg, class_inputs, batch.utt_gather,
                batch.utt_mask, generator, train, bn_dec,
                capture_kd)
        else:
            enc_seg = gather_token_vectors(hs_cond, batch.seg_utt,
                                           batch.seg_tok,
                                           batch.frame_mask[:, 0])
            seg_targets = gather_segments(batch.mel, batch.seg_utt,
                                          batch.seg_start, batch.frame_mask)
            dec = decoder_teacher_forced(
                self.decoder, cfg, enc_seg, seg_targets, batch.position,
                batch.utt_gather, batch.utt_mask, generator, train, bn_dec,
                capture_kd)
        after, before = dec[:2]
        loss, report = self._losses(batch, after, before, d_outs, p_outs,
                                    e_outs, pad_mask)
        new_state = {}
        for prefix, stats in (("encoder.convs.bns", bn_enc),
                              ("decoder.postnet.bns", bn_dec)):
            for i, (mean, var) in enumerate(stats):
                new_state[f"{prefix}.{i}.running_mean"] = mean
                new_state[f"{prefix}.{i}.running_var"] = var
        knowledge = None
        if capture_kd:
            knowledge = {"after_outs": after, "before_outs": before,
                         "encoder": enc_kd, "decoder": dec[2],
                         "prosody": [d_outs[..., None], p_outs, e_outs,
                                     p_embs, e_embs]}
        return loss, (report, new_state, knowledge)

    def _encode_and_predict(self, batch, generator, train, bn_out,
                            capture_kd=False):
        """Encoder + duration/pitch/energy predictors + prosody embeds
        (``taco2_sa.py:130-167``); the embeds take the ground-truth f0 and
        energy (e2e_tts_tacotron2_sa.py:582-583)."""
        cfg = self.cfg
        Tmax = batch.tokens.shape[1]
        hs = encoder_apply(self.encoder, cfg, batch.tokens, batch.ilens,
                           generator, train, bn_out, capture_kd)
        enc_kd = None
        if capture_kd:
            hs, enc_kd = hs
        if cfg.spk_embed_dim:
            hs = _concat_spemb(hs, batch.spembs)
        pad_mask = lengths_to_pad_mask(batch.ilens, Tmax)
        d_outs = C.duration_predictor_apply(
            self.duration_predictor, hs, pad_mask, generator,
            cfg.duration_predictor_dropout_rate, train)
        p_outs = e_outs = p_embs = e_embs = None
        if cfg.use_fe_condition:
            p_outs = C.variance_predictor_apply(
                self.pitch_predictor, hs, pad_mask, generator,
                cfg.pitch_predictor_dropout_rate, train)
            e_outs = C.variance_predictor_apply(
                self.energy_predictor, hs, pad_mask, generator,
                cfg.energy_predictor_dropout_rate, train)
            p_embs = C.scalar_embed_apply(
                self.pitch_embed, batch.f0, generator,
                cfg.pitch_embed_dropout_rate, train)
            e_embs = C.scalar_embed_apply(
                self.energy_embed, batch.energy, generator,
                cfg.energy_embed_dropout_rate, train)
        return hs, pad_mask, d_outs, p_outs, e_outs, p_embs, e_embs, enc_kd

    def _losses(self, batch, after, before, d_outs, p_outs, e_outs,
                pad_mask):
        """The five loss terms in fp32 (``taco2_sa.py:230-300``).  On a
        rank's share of a global batch (``batch.counts``) every term
        divides by the global batch's count, so the ranks' terms sum to
        the global batch's."""
        cfg = self.cfg
        g = batch.counts
        mel32 = batch.mel.float()
        after, before = after.float(), before.float()
        if cfg.use_masking or cfg.use_weighted_masking:
            out_mask = batch.utt_mask[..., None]
            if cfg.reduction_factor > 1:
                # the reference drops the mod-r tail of the targets
                # (e2e_tts_tacotron2_sa.py:595-599), for both reductions
                olens_r = batch.olens - batch.olens % cfg.reduction_factor
                out_mask = out_mask & lengths_to_non_pad_mask(
                    olens_r, batch.mel.shape[1])[..., None]
            n_out = None if g is None else count_frames(
                g, cfg.reduction_factor)
        else:
            out_mask = None  # plain means over the padded buffers
            n_out = None if g is None else g[N_UTTS]
        in_mask = ~pad_mask
        n_in = None if g is None else g[TOKENS]
        if cfg.use_weighted_masking:
            n_valid = torch.sum(batch.olens > 0).float() if g is None \
                else g[N_VALID]
            l1 = weighted_l1(after, mel32, out_mask, n_valid) + \
                weighted_l1(before, mel32, out_mask, n_valid)
            mse = weighted_mse(after, mel32, out_mask, n_valid) + \
                weighted_mse(before, mel32, out_mask, n_valid)
            dur = C.duration_loss(d_outs.float(), batch.durations, in_mask,
                                  offset=cfg.duration_predictor_offset,
                                  weighted_n_valid=n_valid)
        else:
            l1 = masked_l1(after, mel32, out_mask, n_out) + \
                masked_l1(before, mel32, out_mask, n_out)
            mse = masked_mse(after, mel32, out_mask, n_out) + \
                masked_mse(before, mel32, out_mask, n_out)
            # the duration loss is always masked (:560-565)
            dur = C.duration_loss(d_outs.float(), batch.durations, in_mask,
                                  offset=cfg.duration_predictor_offset,
                                  count=n_in)
        loss = l1 + mse + dur
        report = {"l1_loss": l1, "mse_loss": mse, "dur_loss": dur}
        if cfg.use_fe_condition:
            f0, en = batch.f0.float(), batch.energy.float()
            if cfg.use_weighted_masking:
                pitch = weighted_mse(p_outs.float(), f0, in_mask[..., None],
                                     n_valid)
                energy = weighted_mse(e_outs.float(), en, in_mask[..., None],
                                      n_valid)
            else:
                fe_mask = in_mask[..., None] if cfg.use_masking else None
                n_fe = n_in if cfg.use_masking \
                    else None if g is None else g[N_UTTS]
                pitch = masked_mse(p_outs.float(), f0, fe_mask, n_fe)
                energy = masked_mse(e_outs.float(), en, fe_mask, n_fe)
            loss = loss + pitch + energy
            report["pitch_loss"] = pitch
            report["energy_loss"] = energy
        report["loss"] = loss
        return loss, {k: v.detach() for k, v in report.items()}

    # ---------------- inference ----------------

    @torch.no_grad()
    def synth_frontend(self, tokens, ilens, durations=None, f0=None,
                       energy=None, spembs=None, d_factor=1.0):
        """Encoder + duration/pitch/energy predictors + fe-conditioning
        (``taco2_sa.py:321-376``).  Runs in the parameters' dtype (call it
        on ``compute_model()``).  ``d_factor``: a float or a 0-d fp32
        tensor (a graph's input, as JAX keeps it traced).  Returns (hs,
        d_outs, p_outs, e_outs)."""
        cfg = self.cfg
        Tmax = tokens.shape[1]
        hs = encoder_apply(self.encoder, cfg, tokens, ilens)
        if cfg.spk_embed_dim:
            hs = _concat_spemb(hs, spembs)
        pad_mask = lengths_to_pad_mask(ilens, Tmax)

        if durations is None:
            d_outs = C.duration_predictor_inference(
                self.duration_predictor, hs, pad_mask,
                offset=cfg.duration_predictor_offset)
        else:
            d_outs = durations.to(torch.int32)
        # speaking-rate knob for both sources (exact identity at 1.0)
        d_outs = torch.round(d_outs.float() * torch.as_tensor(
            d_factor, dtype=torch.float32)).to(torch.int32)
        d_outs = torch.clamp(d_outs, 0, cfg.max_dur).masked_fill(pad_mask, 0)

        p_outs = e_outs = None
        if cfg.use_fe_condition:
            if f0 is None:
                p_outs = C.variance_predictor_apply(self.pitch_predictor, hs,
                                                    pad_mask)
                e_outs = C.variance_predictor_apply(self.energy_predictor,
                                                    hs, pad_mask)
            else:
                p_outs, e_outs = f0.to(hs.dtype), energy.to(hs.dtype)
            hs = (hs + C.scalar_embed_apply(self.pitch_embed, p_outs)
                  + C.scalar_embed_apply(self.energy_embed, e_outs))
        return hs, d_outs, p_outs, e_outs

    @torch.no_grad()
    def synthesize(self, tokens, ilens, rng, frame_budget: int,
                   durations=None, f0=None, energy=None, spembs=None,
                   d_factor=1.0, decoder_backend: str = "auto",
                   ragged_decode: bool = True, quantize: str = "none",
                   prequant=None):
        """Batched synthesis on the model's device (``taco2_sa.py:378-494``).

        Args:
            tokens: (B, Tmax) int (PAD=0); ilens: (B,) lengths.
            rng: int seed or ``torch.Generator`` for the prenet dropout,
                or a (1,) int32 tensor: the decoder kernels' seed itself
                (the scan seeds a generator with it, on the host).
            frame_budget: per-utterance output frame budget (Lmax).
            durations/f0/energy: optional (B, Tmax)/(B, Tmax, 1) overrides.
            d_factor: multiplies the durations (speaking rate); a float or
                a 0-d fp32 tensor.
            decoder_backend: "auto" | "scan" | "pallas" (resident CUDA
                entry) | "pallas_hbm" (streaming CUDA entry) | "hybrid".
            ragged_decode: sort segments by duration and bound every
                backend by the actual durations.
            quantize: "none" | "int8" (streaming entry only).
            prequant: optional int8 codes from
                ``ops.decoder_cuda.prequantize_hbm_weights``.
        Returns dict(mel=(B, frame_budget, odim) f32, olens, d_outs,
        p_outs, e_outs).

        Nothing here reads the device from the host and every shape is
        static, on every decoder route (the scan and ``hybrid`` run their
        loops to the static step count, frames past the bound zero), so a
        CUDA graph captures the whole call (``infer/synth.py``), given a
        generator (an int or a seed tensor seeds one on the host).  Its
        spans (``utils/spans.py``): ``serve.frontend`` (encoder,
        predictors, the segment plan, the token gather),
        ``serve.decoder`` (``decode_segments``, every route) and
        ``serve.postnet`` (the scatter, the postnet and the mask).
        """
        m = self.compute_model()
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        dev = m.device
        gen = rng if torch.is_tensor(rng) else make_generator(rng, dev)
        B, Tmax = tokens.shape
        D = cfg.max_dur
        P = B * Tmax  # one segment slot per token

        with span("serve.frontend"):
            hs, d_outs, p_outs, e_outs = m.synth_frontend(
                tokens, ilens, durations=durations, f0=f0, energy=energy,
                spembs=spembs, d_factor=d_factor)

            # ---- device-side segment plan from durations ----
            flat_dur = d_outs.reshape(P)
            slots = torch.arange(P, dtype=torch.int64, device=dev)
            seg_utt, seg_tok = slots // Tmax, slots % Tmax
            csum = torch.cumsum(d_outs, dim=1, dtype=torch.int32)
            seg_start = (csum - d_outs).reshape(P)
            olens = torch.clamp(csum[:, -1], max=frame_budget)
            tile_bounds = step_bound = None
            if ragged_decode:
                # duration-sorted slot order: every later use of a segment
                # is index-driven, so permuting the index vectors relabels
                # slots
                order = torch.argsort(-flat_dur, stable=True)
                flat_dur, seg_utt = flat_dur[order], seg_utt[order]
                seg_tok, seg_start = seg_tok[order], seg_start[order]
                tile_bounds = K.tile_step_bounds(flat_dur)
                step_bound = flat_dur.max()
            d_range = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
            frame_mask = d_range < flat_dur[:, None]
            position = torch.where(
                frame_mask,
                d_range.float()
                / torch.clamp(flat_dur[:, None], min=1).float(),
                0.0).to(dtype)

            enc_seg = gather_token_vectors(hs, seg_utt, seg_tok)
        with span("serve.decoder"):
            seg_out = m.decode_segments(
                enc_seg, flat_dur, position, frame_mask, gen,
                decoder_backend=decoder_backend, tile_bounds=tile_bounds,
                step_bound=step_bound, quantize=quantize, prequant=prequant)

        with span("serve.postnet"):
            before = scatter_to_timelines(seg_out, frame_mask, seg_utt,
                                          seg_start, B, frame_budget)
            seq_mask = lengths_to_non_pad_mask(olens, frame_budget)
            after = apply_postnet_inference(m.decoder, cfg, before,
                                            seq_mask=seq_mask)
            after = after * seq_mask[..., None].to(after.dtype)
        return {"mel": after.float(), "olens": olens, "d_outs": d_outs,
                "p_outs": p_outs, "e_outs": e_outs}

    # ---- what ``infer/synth.py::Synthesizer`` asks of the model it serves

    def serve_options(self, quantize="none", decoder_backend="auto",
                      ragged_decode=True, sharded=False):
        """``synthesize``'s serving keywords, made once: the int8 codes
        where the streaming entry takes them."""
        prequant = None
        if decoder_backend in ("auto", "pallas_hbm", "hybrid"):
            prequant = K.maybe_prequantize(self.cfg,
                                           self.decoder.jax_layout(),
                                           quantize)
        return dict(ragged_decode=bool(ragged_decode), quantize=quantize,
                    decoder_backend=decoder_backend, prequant=prequant)

    def serve_plan(self, token_lists, durations, rows, Tmax, d_factor,
                   frame_per_token):
        """(frames the batch needs, whether that is exact, the durations
        padded to (rows, Tmax) int32).  Given durations the need is the
        device's per-phoneme round(d * d_factor) + clip, so it never
        truncates; predicted ones get a guess, and ``frames_needed``."""
        durs = np.zeros((rows, Tmax), np.int32)
        if durations is None:
            return (int(math.ceil(Tmax * frame_per_token
                                  * max(d_factor, 1.0))), False, durs)
        need = max(
            int(np.clip(np.round(np.asarray(d, np.float32)
                                 * np.float32(d_factor)),
                        0, self.cfg.max_dur).sum())
            for d in durations)
        for i, (t, d) in enumerate(zip(token_lists, durations)):
            durs[i, :len(t)] = d
        return need, True, durs

    def serve(self, tokens, ilens, rng, frame_budget, targets, d_factor,
              **options):
        """``synthesize`` with ``targets`` as the durations."""
        return self.synthesize(tokens, ilens, rng, frame_budget,
                               durations=targets, d_factor=d_factor,
                               **options)

    @staticmethod
    def frames_needed(out, n):
        """The frames the first ``n`` rows' predicted durations take."""
        return int(out["d_outs"][:n].sum(dim=1).max())

    @torch.no_grad()
    def decode_segments(self, enc_seg, flat_dur, position, frame_mask,
                        generator, decoder_backend: str = "auto",
                        tile_bounds=None, step_bound=None,
                        quantize: str = "none", prequant=None):
        """AR-decode a batch of phoneme segments -> (P, max_dur, odim)
        (``taco2_sa.py:496-669``).  Parameters must already be in the
        compute dtype.  ``generator``: a ``torch.Generator``, or on the
        kernel routes a (1,) int32 tensor, the kernels' seed itself.

        Policy on the card: ``auto`` takes the resident entry
        (``fused_ar_decode``, fp32 weights) for configs whose decoder
        weights total at most ``ops.decoder_cuda.L2_RESIDENT_BYTES`` in
        fp32 (the student), the streaming entry (``fused_ar_decode_hbm``,
        bf16 or int8) for the other ``hbm_stream_compatible`` configs (the
        teacher), at every P, and ``scan`` otherwise.  Both entries run the
        same kernel, which keeps each block's share of the recurrent
        matrices in shared memory for the whole launch where it fits (the
        student in fp32, the teacher in bf16 or int8); the weights are
        packed once per weight dtype (``packed_decoder``).  ``auto`` never
        picks ``hybrid`` (its measured gain was the TPU's); on CPU tensors
        ``auto`` is ``scan``, as the JAX package's ``auto`` is off the TPU.
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        P, D = frame_mask.shape
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', "
                             f"got {quantize!r}")
        use_pallas, use_hbm, use_hybrid, kernel_wdt = self._decode_policy(
            decoder_backend, enc_seg.is_cuda, P, tile_bounds is not None)
        kernel_path = use_pallas or use_hbm or use_hybrid
        if kernel_path:
            dec_params = self.decoder.jax_layout()
            seed = kernel_seed(generator, enc_seg.device)
            kw = dict(zoneout=cfg.zoneout_rate, dropout=cfg.dropout_rate)
            stream_wdt = torch.int8 if quantize == "int8" else torch.bfloat16
        elif torch.is_tensor(generator):
            generator = make_generator(generator, enc_seg.device)
        fmask = frame_mask[..., None].to(dtype)
        if use_pallas:
            if enc_seg.is_cuda:
                kw["packed"] = self.packed_decoder(enc_seg.shape[1],
                                                   kernel_wdt)
            seg_out = K.fused_ar_decode(dec_params, enc_seg, position, seed,
                                        weights_dtype=kernel_wdt,
                                        bounds=tile_bounds, **kw)
            return seg_out.to(dtype) * fmask
        if (use_hbm or use_hybrid) and enc_seg.is_cuda:
            kw["packed"] = self.packed_decoder(enc_seg.shape[1], stream_wdt,
                                               prequant)
        if use_hbm:
            seg_out = K.fused_ar_decode_hbm(
                dec_params, enc_seg, position, seed, weights_dtype=stream_wdt,
                bounds=tile_bounds, prequant=prequant, **kw)
            return seg_out.to(dtype) * fmask
        if use_hybrid:
            # head tile (the long-duration tail after the descending sort)
            # on the streaming kernel, the rest on one scan at the
            # residual bound
            T = K.TILE
            head = K.fused_ar_decode_hbm(
                dec_params, enc_seg[:T], position[:T], seed,
                weights_dtype=stream_wdt, bounds=tile_bounds[:1],
                prequant=prequant, **kw)
            head = head.to(dtype) * fmask[:T]
            rest = decoder_inference(
                self.decoder, cfg, enc_seg[T:], flat_dur[T:], position[T:],
                frame_mask[T:], generator, step_bound=tile_bounds[1:].max())
            return torch.cat([head, rest.to(dtype)], dim=0)
        return decoder_inference(self.decoder, cfg, enc_seg, flat_dur,
                                 position, frame_mask, generator,
                                 step_bound=step_bound)

    def decode_route(self, decoder_backend="auto", on_cuda=True, P=None):
        """The decoder route ``decode_segments`` takes: "pallas" (the
        resident entry), "pallas_hbm" (the streaming entry), "hybrid" or
        "scan".  ``P`` (segments) decides whether ``hybrid`` has more than
        one tile (unknown: it has)."""
        use_pallas, use_hbm, use_hybrid, _ = self._decode_policy(
            decoder_backend, on_cuda, K.TILE + 1 if P is None else P, True)
        return ("pallas" if use_pallas else "pallas_hbm" if use_hbm
                else "hybrid" if use_hybrid else "scan")

    def _decode_policy(self, decoder_backend, on_cuda, P, ragged):
        """(use_pallas, use_hbm, use_hybrid, kernel_wdt) of
        ``decode_segments``; raises where the backend cannot run."""
        cfg = self.cfg
        pallas_compatible = (cfg.prenet_layers == 2 and cfg.append_position
                             and cfg.use_concate and cfg.dlayers == 2
                             and cfg.reduction_factor == 1)
        if K.fits_l2(cfg, torch.float32):
            kernel_wdt = torch.float32
        elif K.fits_l2(cfg, torch.bfloat16):
            kernel_wdt = torch.bfloat16
        else:
            kernel_wdt = None
        hbm_ok = K.hbm_stream_compatible(cfg) and kernel_wdt is None
        use_hybrid = False
        if decoder_backend == "auto":
            use_pallas = on_cuda and pallas_compatible and \
                kernel_wdt is not None
            use_hbm = on_cuda and not use_pallas and hbm_ok
        elif decoder_backend == "pallas_hbm":
            use_pallas, use_hbm = False, True
            if not K.hbm_stream_compatible(cfg):
                raise ValueError(
                    "decoder_backend='pallas_hbm' requires prenet_layers=2, "
                    "append_position, use_concate, dlayers=2, "
                    "reduction_factor=1 and dunits % 256 == 0")
        elif decoder_backend == "hybrid":
            use_pallas, use_hbm, use_hybrid = False, False, True
            if not K.hbm_stream_compatible(cfg):
                raise ValueError(
                    "decoder_backend='hybrid' requires the pallas_hbm-"
                    "compatible topology (prenet_layers=2, "
                    "append_position, use_concate, dlayers=2, "
                    "reduction_factor=1, dunits % 256 == 0)")
            if not ragged:
                raise ValueError(
                    "decoder_backend='hybrid' requires ragged_decode "
                    "(duration-sorted segments with per-tile bounds)")
            if P <= K.TILE:
                use_hybrid, use_hbm = False, True
        else:
            use_hbm = False
            use_pallas = decoder_backend == "pallas"
            if use_pallas and not pallas_compatible:
                raise ValueError(
                    "decoder_backend='pallas' requires prenet_layers=2, "
                    "append_position, use_concate, dlayers=2 and "
                    "reduction_factor=1")
            if use_pallas and kernel_wdt is None:
                raise ValueError(
                    "decoder_backend='pallas' but the decoder weights stay "
                    "L2-resident in neither fp32 nor bf16 (ops/decoder_cuda."
                    "fits_l2); use decoder_backend='auto', 'pallas_hbm' "
                    "or 'scan'")
        return use_pallas, use_hbm, use_hybrid, kernel_wdt
