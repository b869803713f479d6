"""Semi-autoregressive decoder over the flattened phoneme batch, inference
path (port of ``fcl_taco2_tpu/models/decoder.py:389-474``).

Per step (reference ``decoder_sa.py:591-617``):

    x_t = concat(enc_vec, prenet(prev_frame), position_t)
    z_0 = ZoneOutLSTM_0(x_t); z_i = ZoneOutLSTM_i(z_{i-1})
    out_t = feat_out(concat(z_last, enc_vec)), fed back as prev_frame

``decoder_inference`` is the ``"scan"`` backend: a Python step loop of
PyTorch ops.  The fused kernels of ``ops/decoder_cuda.py`` run the same
loop in one launch.
"""

import torch.nn as nn
import torch.nn.functional as F

from fcl_taco2_tpu_torch.models import components as C
from fcl_taco2_tpu_torch.ops.rnn import lstm_cell, zoneout


class Decoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
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


def decoder_inference(decoder, cfg, enc_seg, seg_dur, position, frame_mask,
                      generator, step_bound=None):
    """Autoregressive synthesis over the phoneme batch, eval mode
    (``decoder.py:389-461``).  Prenet dropout stays active and draws from
    ``generator``.  ``step_bound`` (the batch's max duration in frames)
    stops the loop after ceil(step_bound / r) steps; later frames stay
    zero.  Returns seg_out (P, D, odim) before the postnet."""
    del seg_dur  # durations reach the loop through frame_mask/step_bound
    P, D = frame_mask.shape
    r = cfg.reduction_factor
    S = D // r
    dtype = enc_seg.dtype
    odim = cfg.odim

    # hoisted step-invariant GEMMs: enc's layer-0 gate contribution and
    # enc's feat_out half
    w_enc, w_pre, w_pos = _split_lstm0_wx(decoder, cfg, enc_seg.shape[-1])
    enc_gates = F.linear(enc_seg, w_enc, decoder.lstm[0].bias_ih)
    wf_z, wf_enc = _split_feat_out(decoder, cfg)
    enc_out = F.linear(enc_seg, wf_enc) if wf_enc is not None else None

    n_steps = S
    if step_bound is not None:
        n_steps = min((int(step_bound) + r - 1) // r, S)
    carry = [enc_seg.new_zeros(P, cfg.dunits) for _ in range(2 * cfg.dlayers)]
    prev = enc_seg.new_zeros(P, odim)
    outs = enc_seg.new_zeros(S, P, decoder.feat_out.weight.shape[0])
    for s in range(n_steps):
        x = prev if decoder.prenet is None else C.prenet_apply(
            decoder.prenet, prev, generator, cfg.dropout_rate)
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
    seg_out = _unfold_r(outs, P, S, odim, r)
    return seg_out * frame_mask[..., None].to(dtype)


def apply_postnet_inference(decoder, cfg, before, seq_mask=None):
    """Postnet in eval mode on (B, L, odim); returns after_outs
    (``decoder.py:464-474``)."""
    if decoder.postnet is None:
        return before
    return before + C.postnet_apply(decoder.postnet, before,
                                    seq_mask=seq_mask)
