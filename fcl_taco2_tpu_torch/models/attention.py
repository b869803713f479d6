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
applies them as one: ``ops/attn_decode_cuda.py::location_filter`` folds
them into a (2 aconv_filts + 1, att_dim) filter once, in float64, rounded
to the loop's weight type.  The decode (``ops/attn_decode_cuda.py``) runs
the per-step part and sets up the first step's weights; this module holds
the parameters and the once-a-call projection.
"""

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
