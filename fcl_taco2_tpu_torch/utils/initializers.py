"""Seeded parameter init with the JAX package's distributions
(``fcl_taco2_tpu/utils/initializers.py``), drawn from a ``torch.Generator``.

The distributions match, the values do not: JAX and PyTorch generators
give different numbers from one seed.  Used where no trained weights
exist (the card smoke run) — parity tests load JAX weights through
``utils/params.params_from_jax`` instead.
"""

import math

import torch

RELU_GAIN = math.sqrt(2.0)
TANH_GAIN = 5.0 / 3.0


def _uniform_(t, bound, gen):
    vals = torch.empty(t.shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=gen)
    with torch.no_grad():
        t.copy_(vals)


def _linear_(lin, gen):
    """torch nn.Linear default: U(+-1/sqrt(fan_in)) weight and bias."""
    bound = 1.0 / math.sqrt(lin.weight.shape[1])
    _uniform_(lin.weight, bound, gen)
    if lin.bias is not None:
        _uniform_(lin.bias, bound, gen)


def _lstm_(cell, gen):
    """torch nn.LSTMCell default: U(+-1/sqrt(H)) for all four tensors."""
    bound = 1.0 / math.sqrt(cell.hidden_size)
    for t in (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh):
        _uniform_(t, bound, gen)


def _conv_bn_stack_(stack, gain, gen):
    """Xavier-uniform conv kernels (fans include the width); BN identity."""
    for conv in stack.convs:
        out_ch, in_ch, width = conv.weight.shape
        bound = gain * math.sqrt(6.0 / (in_ch * width + out_ch * width))
        _uniform_(conv.weight, bound, gen)
    for bn in stack.bns:
        _bn_(bn)


def _bn_(bn):
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)


def _torch_conv_(conv, gen):
    """torch nn.Conv1d default: U(+-1/sqrt(Cin * W)) weight and bias (if
    any)."""
    _, in_ch, width = conv.weight.shape
    bound = 1.0 / math.sqrt(in_ch * width)
    _uniform_(conv.weight, bound, gen)
    if conv.bias is not None:
        _uniform_(conv.bias, bound, gen)


def _variance_predictor_(vp, gen):
    for conv in vp.convs:
        _torch_conv_(conv, gen)
    for ln in vp.lns:
        with torch.no_grad():
            ln.weight.fill_(1.0)
            ln.bias.zero_()
    _linear_(vp.linear, gen)


def init_tacotron2sa_(model, generator):
    """Fill every parameter of a ``Tacotron2SA`` in place."""
    from fcl_taco2_tpu_torch.models.components import VariancePredictor
    gen = generator
    enc, dec = model.encoder, model.decoder
    emb = torch.empty(enc.embed.weight.shape).normal_(generator=gen)
    emb[0] = 0.0  # padding row
    with torch.no_grad():
        enc.embed.weight.copy_(emb)
    if enc.convs is not None:
        _conv_bn_stack_(enc.convs, RELU_GAIN, gen)
    for layer in enc.blstm:
        _lstm_(layer["fwd"], gen)
        _lstm_(layer["bwd"], gen)
    _linear_(dec.feat_out, gen)
    if dec.prenet is not None:
        for lin in dec.prenet.layers:
            _linear_(lin, gen)
    for cell in dec.lstm:
        _lstm_(cell, gen)
    if dec.postnet is not None:
        _conv_bn_stack_(dec.postnet, TANH_GAIN, gen)
    for name, mod in model.named_children():
        if isinstance(mod, VariancePredictor):
            _variance_predictor_(mod, gen)
        elif name.endswith("_embed"):
            _torch_conv_(mod, gen)
    return model


def init_linears_(module, generator):
    """Fill every ``nn.Linear`` inside ``module`` in place with torch's
    default init (``linear_weight``/``linear_bias``)."""
    for mod in module.modules():
        if isinstance(mod, torch.nn.Linear):
            _linear_(mod, generator)
    return module
