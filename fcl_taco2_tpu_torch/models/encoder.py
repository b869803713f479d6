"""Tacotron2-SA encoder: embedding -> N x(conv[-BN]-ReLU) -> BiLSTM
(port of ``fcl_taco2_tpu/models/encoder.py``)."""

import torch
import torch.nn as nn

from fcl_taco2_tpu_torch.models import components as C
from fcl_taco2_tpu_torch.ops.blstm_cuda import bilstm_infer
from fcl_taco2_tpu_torch.ops.masking import lengths_to_non_pad_mask
from fcl_taco2_tpu_torch.ops.rnn import bilstm_stack


class Encoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.embed = nn.Embedding(cfg.idim, cfg.embed_dim, padding_idx=0,
                                  device=device)
        self.convs = None
        if cfg.econv_layers > 0:
            self.convs = C.ConvBNStack(
                cfg.econv_layers, cfg.embed_dim, cfg.econv_chans,
                cfg.econv_chans, cfg.econv_filts, use_bn=cfg.use_batch_norm,
                device=device)
        # layer l: {"fwd", "bwd"} cells, eunits // 2 each direction
        self.blstm = nn.ModuleList()
        lstm_in = cfg.econv_chans if cfg.econv_layers > 0 else cfg.embed_dim
        for layer in range(cfg.elayers):
            d_in = lstm_in if layer == 0 else cfg.eunits
            self.blstm.append(nn.ModuleDict({
                d: nn.LSTMCell(d_in, cfg.eunits // 2, device=device)
                for d in ("fwd", "bwd")}))


def serving_recurrence(train, tokens):
    """True where ``encoder_apply`` runs the BiLSTM through
    ``ops/blstm_cuda.py::bilstm_infer``'s kernel: not training, autograd
    off and the tokens on the card.  Training (the KD teacher's frozen
    forward included) and the CPU keep ``bilstm_stack``."""
    return not train and not torch.is_grad_enabled() and tokens.is_cuda


def encoder_apply(encoder, cfg, tokens, ilens, generator=None, train=False,
                  bn_out=None, capture_kd=False):
    """tokens (B, Tmax) int -> hs (B, Tmax, cfg.enc_odim)
    (``encoder.py:63-88``).  Train mode draws the conv dropout from
    ``generator``, takes BatchNorm statistics over the valid positions
    and appends the new running statistics to ``bn_out``.  With
    ``capture_kd`` returns ``(hs, [embed, conv0..convN-1, blstm])``, the
    KD items of ``encoder_sa_kd.py:196``."""
    x = encoder.embed.weight[tokens]  # PAD row is zeros
    capture = [x] if capture_kd else None
    if encoder.convs is not None:
        seq_mask = lengths_to_non_pad_mask(ilens, tokens.shape[1]) \
            if train else None
        x = C.encoder_convs_apply(
            encoder.convs, x, use_residual=cfg.use_residual,
            generator=generator, dropout_rate=cfg.dropout_rate, train=train,
            seq_mask=seq_mask, bn_out=bn_out, capture=capture)
    if len(encoder.blstm):
        layers = [(lay["fwd"], lay["bwd"]) for lay in encoder.blstm]
        if serving_recurrence(train, tokens):
            for fwd, bwd in layers:
                x = bilstm_infer(fwd, bwd, x, ilens)
        else:
            x = bilstm_stack(layers, x, ilens)
        if capture_kd:
            capture.append(x)
    return (x, capture) if capture_kd else x
