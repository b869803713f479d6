"""Semi-autoregressive decoder over the flattened phoneme batch (port of
``fcl_taco2_tpu/models/decoder.py``).

Per step (reference ``decoder_sa.py:591-617``):

    x_t = concat(enc_vec, prenet(prev_frame), position_t)
    z_0 = ZoneOutLSTM_0(x_t); z_i = ZoneOutLSTM_i(z_{i-1})
    out_t = feat_out(concat(z_last, enc_vec)), fed back as prev_frame

``decoder_inference`` is the ``"scan"`` backend: a Python step loop of
PyTorch ops.  The fused kernels of ``ops/decoder_cuda.py`` run the same
loop in one launch.  Training runs the teacher-forced pass
(``decoder_teacher_forced``): the prenet over all steps as one GEMM chain,
then the LSTM stack through ``ops/rnn_vjp.py``'s hand-built backward.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from fcl_taco2_tpu_torch.models import components as C
from fcl_taco2_tpu_torch.ops.regroup import (scatter_frames,
                                             scatter_frames_classed)
from fcl_taco2_tpu_torch.ops.rnn import (lstm_cell, zoneout,
                                         zoneout_keep_masks)
from fcl_taco2_tpu_torch.ops.rnn_vjp import (ScanSpec, scan_plain,
                                             zoneout_lstm_scan)


class Decoder(nn.Module):
    """``mask_taps``: None, or a list that receives every train-mode
    zoneout mask tensor as it is drawn, so a check can read the masks a
    CUDA graph replay drew (the tensors a capture records are the graph's
    own buffers)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.mask_taps = None
        idim = cfg.dec_idim
        lstm0_in = (idim + cfg.effective_prenet_units
                    + (1 if cfg.append_position else 0))
        feat_in = (idim + cfg.dunits) if cfg.use_concate else cfg.dunits
        # feat_out is bias-free (decoder_sa.py:398); input order (z, enc)
        self.feat_out = nn.Linear(feat_in, cfg.odim * cfg.reduction_factor,
                                  bias=False, device=device)
        self.prenet = None
        if cfg.prenet_layers > 0:
            self.prenet = C.Prenet(cfg.odim, cfg.prenet_layers,
                                   cfg.prenet_units, device=device)
        self.lstm = nn.ModuleList(
            nn.LSTMCell(lstm0_in if i == 0 else cfg.dunits, cfg.dunits,
                        device=device)
            for i in range(cfg.dlayers))
        self.postnet = None
        if cfg.postnet_layers > 0:
            self.postnet = C.ConvBNStack(
                cfg.postnet_layers, cfg.odim, cfg.postnet_chans, cfg.odim,
                cfg.postnet_filts, last_is_out=True,
                use_bn=cfg.use_batch_norm, device=device)

    def jax_layout(self):
        """Views of the AR-loop weights in the JAX package's layout —
        matrices (in, out), LSTM ``wx``/``wh``/``bx``/``bh`` — the
        ``dec_params`` the kernel wrappers of ``ops/decoder_cuda.py``
        take, as ``fused_ar_decode`` takes the JAX decoder pytree."""
        out = {"feat_out": {"w": self.feat_out.weight.t()}}
        if self.prenet is not None:
            out["prenet"] = {"layers": [{"w": lay.weight.t(), "b": lay.bias}
                                        for lay in self.prenet.layers]}
        for i, cell in enumerate(self.lstm):
            out[f"lstm{i}"] = {"wx": cell.weight_ih.t(),
                               "wh": cell.weight_hh.t(),
                               "bx": cell.bias_ih, "bh": cell.bias_hh}
        return out


def _split_lstm0_wx(decoder, cfg, idim):
    """Column blocks of lstm0's input weight for the concat order
    [enc_seg, prenet_out, position] (``decoder.py:122-133``)."""
    w = decoder.lstm[0].weight_ih  # (4H, in)
    u = cfg.effective_prenet_units
    w_pos = w[:, idim + u] if cfg.append_position else None  # (4H,)
    return w[:, :idim], w[:, idim:idim + u], w_pos


def _split_feat_out(decoder, cfg):
    """feat_out column blocks for the input order [z_last, enc_seg]
    (``decoder.py:136-142``)."""
    wf = decoder.feat_out.weight  # (odim * r, in)
    if not cfg.use_concate:
        return wf, None
    return wf[:, :cfg.dunits], wf[:, cfg.dunits:]


def _unfold_r(outs_steps, P, S, odim, r):
    """(S, P, odim*r) step outputs -> (P, S*r, odim) frames; flat element
    [o*r + j] is mel bin o of sub-frame j (``decoder.py:156-166``)."""
    seg = outs_steps.transpose(0, 1)  # (P, S, odim*r)
    if r == 1:
        return seg
    seg = seg.reshape(P, S, odim, r)
    return seg.transpose(2, 3).reshape(P, S * r, odim)


def _prenet_draws(decoder, cfg, S, P, device, generator):
    """The prenet dropout's uniform draws for all ``S`` steps up front, one
    (S, P, units) tensor a layer, as JAX splits ``S`` keys up front
    (``decoder.py:413``): the generator's state after a decode does not
    depend on how many steps its bound lets run."""
    if decoder.prenet is None or cfg.dropout_rate <= 0.0:
        return None
    return [torch.rand((S, P, lay.out_features), generator=generator,
                       device=device) for lay in decoder.prenet.layers]


def _prenet_step(decoder, x, draws, s, rate):
    """The prenet at step ``s`` with its dropout masks from ``draws``
    (``ops/rnn.py::prenet_dropout``'s rule: keep below 1 - rate)."""
    for i, layer in enumerate(decoder.prenet.layers):
        x = F.relu(layer(x))
        if draws is not None:
            x = torch.where(draws[i][s] < 1.0 - rate, x / (1.0 - rate),
                            torch.zeros_like(x))
    return x


def decoder_inference(decoder, cfg, enc_seg, seg_dur, position, frame_mask,
                      generator, step_bound=None):
    """Autoregressive synthesis over the phoneme batch, eval mode
    (``decoder.py:389-461``).  Prenet dropout stays active and draws from
    ``generator``, every step's masks up front.  ``step_bound`` (the
    batch's max duration in frames, a tensor on the device): the steps
    from ceil(step_bound / r) on come back exactly zero, as JAX's traced
    bound leaves them.  The loop runs to the static ``S = max_dur / r``
    whatever the bound, so nothing is read on the host and a CUDA graph
    captures it (``infer/synth.py``).  Returns seg_out (P, D, odim)
    before the postnet."""
    del seg_dur  # durations reach the loop through frame_mask/step_bound
    P, D = frame_mask.shape
    r = cfg.reduction_factor
    S = D // r
    dtype = enc_seg.dtype
    odim = cfg.odim
    draws = _prenet_draws(decoder, cfg, S, P, enc_seg.device, generator)

    # hoisted step-invariant GEMMs: enc's layer-0 gate contribution and
    # enc's feat_out half
    w_enc, w_pre, w_pos = _split_lstm0_wx(decoder, cfg, enc_seg.shape[-1])
    enc_gates = F.linear(enc_seg, w_enc, decoder.lstm[0].bias_ih)
    wf_z, wf_enc = _split_feat_out(decoder, cfg)
    enc_out = F.linear(enc_seg, wf_enc) if wf_enc is not None else None

    carry = [enc_seg.new_zeros(P, cfg.dunits) for _ in range(2 * cfg.dlayers)]
    prev = enc_seg.new_zeros(P, odim)
    outs = enc_seg.new_zeros(S, P, decoder.feat_out.weight.shape[0])
    for s in range(S):
        x = prev if decoder.prenet is None else _prenet_step(
            decoder, prev, draws, s, cfg.dropout_rate)
        xproj = enc_gates + F.linear(x, w_pre)
        if cfg.append_position:
            xproj = xproj + position[:, s, None] * w_pos
        inp = None
        for i, cell in enumerate(decoder.lstm):
            h, c = carry[2 * i], carry[2 * i + 1]
            if i == 0:
                nh, nc = lstm_cell(cell, None, h, c, precomputed_xproj=xproj)
            else:
                nh, nc = lstm_cell(cell, inp, h, c)
            carry[2 * i] = zoneout(h, nh, cfg.zoneout_rate)
            carry[2 * i + 1] = zoneout(c, nc, cfg.zoneout_rate)
            inp = carry[2 * i]
        out_t = F.linear(inp, wf_z)
        if enc_out is not None:
            out_t = out_t + enc_out
        outs[s] = out_t
        # AR feedback: last sub-frame of the group (decoder_sa.py:617)
        prev = out_t if r == 1 else out_t.reshape(P, odim, r)[..., -1]
    if step_bound is not None:
        n_steps = torch.clamp(torch.div(step_bound + r - 1, r,
                                        rounding_mode="floor"), max=S)
        live = torch.arange(S, device=outs.device) < n_steps
        outs = torch.where(live[:, None, None], outs, torch.zeros_like(outs))
    seg_out = _unfold_r(outs, P, S, odim, r)
    return seg_out * frame_mask[..., None].to(dtype)


def apply_postnet_inference(decoder, cfg, before, seq_mask=None):
    """Postnet in eval mode on (B, L, odim); returns after_outs
    (``decoder.py:464-474``)."""
    if decoder.postnet is None:
        return before
    return before + C.postnet_apply(decoder.postnet, before,
                                    seq_mask=seq_mask)


# --------------------------------------------------------------------------
# Teacher-forced training pass
# --------------------------------------------------------------------------

def decoder_teacher_forced(decoder, cfg, enc_seg, seg_targets, position,
                           utt_gather, utt_mask, generator, train,
                           bn_out=None, capture_kd=False):
    """Teacher-forced pass over the phoneme batch (``decoder.py:169-209``).

    Args:
        enc_seg: (P, idim) per-segment encoder vectors (prosody added).
        seg_targets: (P, D, odim) per-segment target frames (zero padded).
        position: (P, D) position ramps.
        utt_gather/utt_mask: the regroup plan back to utterance-major.
        generator: the step's ``torch.Generator``: the prenet dropout,
            the zoneout masks and the postnet dropout draw from it, in
            that order.
        bn_out: list receiving the postnet BatchNorms' new running
            statistics in train mode.
        capture_kd: also return the KD items.
    Returns (after_outs, before_outs), each (B, Lmax, odim), and with
    ``capture_kd`` a third item: the KD items utterance-major
    (``decoder_sa_kd.py:627-702``), ``[prenet, lstm0, lstm1,
    postnet layer 0 .. n-1]``.
    """
    if capture_kd:
        _check_kd_topology(cfg)
    core = _teacher_forced_core(decoder, cfg, enc_seg, seg_targets,
                                position, generator, train,
                                capture_kd=capture_kd)
    seg_out, items = (core[0], core[1:]) if capture_kd else (core, ())
    before = scatter_frames(seg_out, utt_gather, utt_mask)
    post = [] if capture_kd else None
    after = _apply_train_postnet(decoder, cfg, before, generator, train,
                                 utt_mask, bn_out, post)
    if not capture_kd:
        return after, before
    # the captures are regrouped utterance-major like the outputs; the
    # postnet's already are
    kd = [scatter_frames(x, utt_gather, utt_mask) for x in items]
    return after, before, kd + post


def decoder_teacher_forced_classed(decoder, cfg, class_inputs, utt_gather,
                                   utt_mask, generator, train,
                                   bn_out=None, capture_kd=False):
    """Duration-classed teacher-forced pass (``decoder.py:212-255``): one
    scan per duration class, D_c steps each, then one gather back to
    utterance-major through the concatenated class flats.  Each segment's
    recurrence is independent and frames past its duration are never
    read, so the losses equal the single-class path's.

    ``class_inputs``: tuple of (enc_seg, seg_targets, position) per class,
    shapes (P_c, idim) / (P_c, D_c, odim) / (P_c, D_c).  Returns as
    ``decoder_teacher_forced``.
    """
    if capture_kd:
        _check_kd_topology(cfg)
    cores = [_teacher_forced_core(decoder, cfg, enc_c, tgt_c, pos_c,
                                  generator, train, capture_kd=capture_kd)
             for enc_c, tgt_c, pos_c in class_inputs]
    outs = [c[0] for c in cores] if capture_kd else cores
    before = scatter_frames_classed(outs, utt_gather, utt_mask)
    post = [] if capture_kd else None
    after = _apply_train_postnet(decoder, cfg, before, generator, train,
                                 utt_mask, bn_out, post)
    if not capture_kd:
        return after, before
    kd = [scatter_frames_classed([c[j] for c in cores], utt_gather, utt_mask)
          for j in (1, 2, 3)]
    return after, before, kd + post


def _check_kd_topology(cfg):
    """``decoder.py:258-265``."""
    if (cfg.dlayers != 2 or cfg.reduction_factor != 1
            or cfg.prenet_layers == 0 or cfg.postnet_layers == 0):
        raise ValueError(
            "capture_kd requires the reference KD topology: dlayers=2, "
            "reduction_factor=1, prenet and postnet present "
            "(decoder_sa_kd.py:627-702)")


def _apply_train_postnet(decoder, cfg, before, generator, train, utt_mask,
                         bn_out, capture=None):
    """Postnet on the utterance-major canvas, training path
    (``decoder.py:267-278``); the mask only applies in train mode.
    ``capture`` receives each postnet layer's output."""
    if decoder.postnet is None:  # decoder_sa.py:393: the postnet is optional
        return before
    return before + C.postnet_apply(
        decoder.postnet, before, seq_mask=utt_mask if train else None,
        generator=generator, dropout_rate=cfg.dropout_rate, train=train,
        bn_out=bn_out, capture=capture)


def _teacher_forced_core(decoder, cfg, enc_seg, seg_targets, position,
                         generator, train, zo_seed=None, capture_kd=False):
    """The teacher-forced scan over one phoneme batch, before regrouping
    (``decoder.py:281-386``): returns seg_out (P, D, odim), and with
    ``capture_kd`` (seg_out, prenet output (P, S, units), h of LSTM 0 and
    of LSTM 1 (P, S, H) each).

    In train mode the zoneout masks of all S steps are drawn in one call
    after the prenet's dropout: from ``generator`` itself, or with an
    int ``zo_seed`` from a fresh generator seeded with it.

    The scan is the hand-built backward (``zoneout_lstm_scan``) unless
    ``remat_decoder`` asks for the autodiff scan with checkpointed steps
    (remat wins, ``decoder.py:337``) or ``decoder_custom_vjp`` is off; with
    no gradient to take (``torch.no_grad``), the plain loop, which saves
    nothing."""
    P, D, odim = seg_targets.shape
    r = cfg.reduction_factor
    S = D // r  # decoder steps
    # teacher-forcing input at step t is target frame t*r-1 (zeros at
    # t=0); r>1 thins the targets to every r-th frame (decoder_sa.py:488)
    thinned = seg_targets if r == 1 else seg_targets[:, r - 1::r]
    prev = torch.cat([seg_targets.new_zeros(P, 1, odim), thinned[:, :-1]],
                     dim=1)
    # hoisted prenet over all steps: one (P*S, odim) GEMM chain
    flat = prev.reshape(P * S, odim)
    prenet_all = flat if decoder.prenet is None else C.prenet_apply(
        decoder.prenet, flat, generator, cfg.dropout_rate)
    prenet_steps = prenet_all.reshape(P, S, -1).transpose(0, 1).contiguous()
    pos_steps = position[:, :S].t().contiguous() if cfg.append_position \
        else None

    # hoisted step-invariant GEMMs: enc's layer-0 gate term and enc's
    # feat_out term (decoder.py:310-329)
    w_enc, w_pre, w_pos = _split_lstm0_wx(decoder, cfg, enc_seg.shape[-1])
    enc_gates = F.linear(enc_seg, w_enc, decoder.lstm[0].bias_ih)
    wf_z, wf_enc = _split_feat_out(decoder, cfg)
    enc_out = F.linear(enc_seg, wf_enc) if wf_enc is not None else None

    spec = ScanSpec(dlayers=cfg.dlayers, dunits=cfg.dunits,
                    zoneout_rate=float(cfg.zoneout_rate), train=bool(train),
                    append_position=bool(cfg.append_position),
                    use_enc_out=enc_out is not None,
                    capture_kd=bool(capture_kd))
    keep = None
    if train and cfg.zoneout_rate > 0.0:
        gen = generator if zo_seed is None \
            else torch.Generator(device=generator.device)
        keep = zoneout_keep_masks(gen, zo_seed, (S, 2 * cfg.dlayers), P,
                                  cfg.dunits, float(cfg.zoneout_rate))
        if decoder.mask_taps is not None:
            decoder.mask_taps.append(keep)
    layers = [(decoder.lstm[0].weight_hh, decoder.lstm[0].bias_hh)]
    for cell in decoder.lstm[1:]:
        layers.append((cell.weight_ih, cell.weight_hh, cell.bias_ih,
                       cell.bias_hh))
    weights = (w_pre, w_pos, wf_z, tuple(layers))
    args = (spec, weights, enc_gates, enc_out, prenet_steps, pos_steps,
            keep)
    if cfg.decoder_custom_vjp and not cfg.remat_decoder \
            and torch.is_grad_enabled():
        res = zoneout_lstm_scan(*args)
    else:
        res = scan_plain(*args, remat=cfg.remat_decoder)
    if not capture_kd:
        return _unfold_r(res, P, S, odim, r)  # (P, D, odim)
    outs, z0s, z1s = res
    return (_unfold_r(outs, P, S, odim, r), prenet_all.reshape(P, S, -1),
            z0s.transpose(0, 1), z1s.transpose(0, 1))
