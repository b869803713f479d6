"""Location-sensitive attention (Chorowski et al. 2015, arXiv:1506.07503)
as espnet builds it (``espnet/nets/pytorch_backend/rnn/attentions.py::
AttLoc``), the attention of ``models/tacotron2.py``.

With ``enc`` (B, T, eprojs), the decoder's first-layer state ``q`` of the
previous step and the running sum ``w_cum`` of the past weights::

    pe    = enc @ W_enc + b_enc                       once a call
    f     = loc_conv(w_cum)            aconv_chans filters of 2 aconv_filts + 1
    e_j   = gvec . tanh(pe_j + q @ W_dec + f_j @ W_att) + b_g
    alpha = softmax(2 e) over each row's own positions
    att_c = sum_j alpha_j enc_j

``loc_conv`` and ``W_att`` are two linear maps in a row, so the port
applies them as one: ``location_filter`` folds them into a
(2 aconv_filts + 1, att_dim) filter once, in float64, rounded to the loop's
weight type.  The decode (``ops/attn_decode_cuda.py``) runs the per-step
part; this module holds the parameters, the once-a-call projection and
the first step's weights.
"""

import torch
import torch.nn as nn


class AttLoc(nn.Module):
    def __init__(self, eprojs, dunits, att_dim, aconv_chans, aconv_filts,
                 device=None):
        super().__init__()
        self.mlp_enc = nn.Linear(eprojs, att_dim, device=device)
        self.mlp_dec = nn.Linear(dunits, att_dim, bias=False, device=device)
        self.mlp_att = nn.Linear(aconv_chans, att_dim, bias=False,
                                 device=device)
        self.loc_conv = nn.Conv1d(1, aconv_chans, 2 * aconv_filts + 1,
                                  padding=aconv_filts, bias=False,
                                  device=device)
        self.gvec = nn.Linear(att_dim, 1, device=device)


def project_memory(att, enc):
    """``pe = enc @ W_enc + b_enc`` (B, T, att_dim) in fp32: the products
    of the compute-dtype operands taken exactly, summed in fp32."""
    return enc.float() @ att.mlp_enc.weight.float().t() \
        + att.mlp_enc.bias.float()


def location_filter(att, dtype):
    """The location convolution and its projection as one filter: (taps,
    att_dim) fp32 holding ``dtype``-rounded values, ``M[k] = sum_c
    conv[c, k] W_att[:, c]`` taken in float64."""
    conv = att.loc_conv.weight[:, 0, :].double()       # (chans, taps)
    m = conv.t() @ att.mlp_att.weight.double().t()      # (taps, att_dim)
    return m.to(dtype).float()


def initial_weights(ilens, T):
    """The first step's ``w_cum``: 1 / ilen over each row's positions
    (B, T) fp32 (espnet's ``att_prev`` at the first step)."""
    valid = torch.arange(T, device=ilens.device)[None, :] < ilens[:, None]
    return valid.float() / ilens.clamp(min=1)[:, None].float()
