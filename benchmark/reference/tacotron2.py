"""Plain Tacotron2 inference with location-sensitive attention: text ->
mel, in PyTorch ops.

Follows espnet's Tacotron2 (``espnet/nets/pytorch_backend/tacotron2/
{encoder,decoder}.py``, ``rnn/attentions.py::AttLoc``; the LJSpeech v3
recipe): the encoder (``reference/taco2.py::encoder``), then per step ``t``
with ``q = h0`` of step t - 1 (zeros at t = 0)::

    e_j   = gvec . tanh(pe_j + q @ W_dec + loc_conv(w_cum)_j @ W_att) + b_g
    alpha = softmax(2 e) over the utterance's positions
    att_c = sum_j alpha_j enc_j
    w_cum = 1/ilen at t = 0 (before the step), alpha after it, + alpha after
    p     = prenet(prev_out), dropout 0.5 on
    h0, c0 = ZoneOutLSTM0([att_c, p]);  h1, c1 = ZoneOutLSTM1(h0)
    out_t = [h1, att_c] @ W_feat;  stop_t = [h1, att_c] @ w_prob + b_prob

ending after the step whose ``sigmoid(stop_t) >= threshold`` or that
reaches ``int(ilen * maxlenratio)`` frames, not before ``int(ilen *
minlenratio)``, or at a pinned length; then ``mel = out + postnet(out)``.

Departures from espnet, each the served model's numerics:

- the prenet dropout is drawn as ``philox.prenet_keep`` keys it (the
  counter (row, step, layer * units + unit)), the row being the
  utterance's index in its call, in place of torch's generator;
- the location convolution and its projection ``W_att`` are applied as one
  filter, ``M[k] = sum_c conv[c, k] W_att[:, c]`` (the same linear map),
  folded in float64 and rounded to the loop's weight type, and ``w_cum``
  is rounded to that type before the product;
- the loop's products take operands rounded to ``loop_dtype`` (bf16) with
  fp32 sums and fp32 state; the energies' dot with ``gvec``, the softmax
  and the context sum are fp32; ``pe`` is the product of the
  compute-dtype encoder output and ``W_enc`` in fp32;
- zoneout blends (h, c) as its expectation at inference, as espnet's
  ``ZoneOutCell`` does in eval mode.

``fault`` plants a change of the mathematics for the output check's
calibration: ``"no_location"`` drops the location term from the
energies, ``"no_cumulate"`` keeps only the last step's weights.

A call's rows run side by side, each to its own end, with every
operation row by row: a row's numbers are those it has alone (the batch
dimension only saves the output check the time of a Python loop a row).

Nothing here imports the program.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.philox import keep_threshold, philox_bits
from benchmark.reference.precision import exact_fp32
from benchmark.reference.taco2 import encoder, postnet


def _cell(g, h, c, z):
    i, f, gg, o = g.chunk(4, dim=-1)
    c_n = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h_n = torch.sigmoid(o) * torch.tanh(c_n)
    return z * h + (1 - z) * h_n, z * c + (1 - z) * c_n


def decode(sd, mc, enc, ilens, seed, pr, loop_dtype, lo, hi, fault=None,
           row_ids=None):
    """The loop of a call's rows side by side, each row to its own end:
    ``enc`` (B, T, E) in the compute dtype, ``ilens`` (B,) its rows'
    positions, ``row_ids`` (B,) their indices in the call (the dropout's
    rows; 0..B-1 by default), ``lo``/``hi`` (B,) a row's least and most
    frames.  Every operation is row by row (a row's numbers do not
    depend on the others); positions past a row's ``ilen`` take no weight.
    Returns a list of fp32 (frames (L, odim), stop logits (L,), attention
    weights (L, ilen)) a row."""
    dev = enc.device
    B, T, _ = enc.shape
    U, H, O = mc["prenet_units"], mc["dunits"], mc["odim"]
    rate, z = mc["dropout_rate"], mc["zoneout_rate"]
    thr = mc["threshold"]
    S = max(hi)
    valid = torch.arange(T, device=dev)[None, :] < \
        torch.as_tensor(ilens, device=dev)[:, None]

    def w(name):
        return pr.loop(sd["decoder." + name], loop_dtype)

    def act(x):
        return pr.loop(x, loop_dtype)

    def vec(name):
        return sd["decoder." + name].float()

    if rate > 0:  # every step's masks at once, keyed as prenet_keep keys
        ids = torch.as_tensor(range(B) if row_ids is None else row_ids,
                              device=dev)
        keep = philox_bits(seed, ids[:, None, None],
                           torch.arange(S, device=dev)[None, :, None],
                           torch.arange(2 * U, device=dev)[None, None, :]) \
            < keep_threshold(rate)                        # (B, S, 2U)

    def drop(x, step, layer):
        if rate <= 0:
            return x
        return torch.where(keep[:, step, layer * U:(layer + 1) * U],
                           x / (1.0 - rate), torch.zeros_like(x))

    conv = sd["decoder.att.loc_conv.weight"][:, 0, :].double()
    m64 = conv.t() @ sd["decoder.att.mlp_att.weight"].double().t()
    M = pr.loop(m64, loop_dtype)                         # (taps, A)
    pad = (M.shape[0] - 1) // 2
    w_dec = w("att.mlp_dec.weight").t()
    g, b_g = pr.f32(vec("att.gvec.weight")[0]), vec("att.gvec.bias")
    w1, w2 = w("prenet.layers.0.weight").t(), w("prenet.layers.1.weight").t()
    b1, b2 = vec("prenet.layers.0.bias"), vec("prenet.layers.1.bias")
    wx0, wh0 = w("lstm.0.weight_ih").t(), w("lstm.0.weight_hh").t()
    wx1, wh1 = w("lstm.1.weight_ih").t(), w("lstm.1.weight_hh").t()
    bx0, bh0 = vec("lstm.0.bias_ih"), vec("lstm.0.bias_hh")
    bx1, bh1 = vec("lstm.1.bias_ih"), vec("lstm.1.bias_hh")
    wf, wp = w("feat_out.weight").t(), w("prob_out.weight").t()
    bp = vec("prob_out.bias")
    with exact_fp32():
        w_enc = sd["decoder.att.mlp_enc.weight"].to(enc.dtype)
        pe = pr.lo(enc).float() @ pr.lo(w_enc).float().t() \
            + vec("att.mlp_enc.bias")
        encf = pr.f32(enc)
        w_cum = valid.float() / valid.sum(1, keepdim=True).clamp(min=1)
        h0 = c0 = h1 = c1 = torch.zeros(B, H, device=dev)
        prev = torch.zeros(B, O, device=dev)
        outs, stops, atts = [], [], []
        ends = [None] * B
        for t in range(S):
            q = act(h0) @ w_dec
            loc = F.conv1d(act(w_cum)[:, None, :], M.t()[:, None, :],
                           padding=pad).transpose(1, 2)
            if fault == "no_location":
                loc = torch.zeros_like(loc)
            e = pr.f32(torch.tanh(pe + q[:, None, :] + loc)) @ g + b_g
            alpha = torch.softmax(
                2.0 * e.masked_fill(~valid, float("-inf")), dim=1)
            alpha = alpha.masked_fill(~valid, 0.0)
            att_c = (pr.f32(alpha)[:, :, None] * encf).sum(dim=1)
            w_cum = alpha if t == 0 or fault == "no_cumulate" \
                else w_cum + alpha
            p = drop(torch.relu(act(prev) @ w1 + b1), t, 0)
            p = drop(torch.relu(act(p) @ w2 + b2), t, 1)
            h0, c0 = _cell(act(torch.cat([att_c, p], 1)) @ wx0 + bx0
                           + act(h0) @ wh0 + bh0, h0, c0, z)
            h1, c1 = _cell(act(h0) @ wx1 + bx1 + act(h1) @ wh1 + bh1,
                           h1, c1, z)
            zc = act(torch.cat([h1, att_c], 1))
            prev = zc @ wf
            stop = (zc @ wp + bp)[:, 0]
            outs.append(prev)
            stops.append(stop)
            atts.append(alpha)
            # a row ends after t + 1 frames at its most, or at its first
            # stop from its least on (read only where lo < hi)
            for b in range(B):
                if ends[b] is None and (
                        t + 1 >= hi[b] or (t + 1 >= lo[b] and bool(
                            torch.sigmoid(stop[b]) >= thr))):
                    ends[b] = t + 1
            if all(x is not None for x in ends):
                break
    outs, stops, atts = (torch.stack(x, 1) for x in (outs, stops, atts))
    return [(outs[b, :ends[b]], stops[b, :ends[b]],
             atts[b, :ends[b], :int(ilens[b])]) for b in range(B)]


@torch.no_grad()
def synthesize(sd, mc, tokens, ilens, seed, pr, loop_dtype, budget,
               lengths=None, fault=None):
    """tokens (B, Tmax) int (0 pads), ilens (B,), ``seed`` the dropout's
    seed as an int, ``mc`` the model's configuration (the ``model`` group
    of a configuration file), ``budget`` the most frames a row may have,
    ``lengths`` (B,) pinned frames or None.  Returns a list of (mel (L,
    odim) fp32, stop logits (L,), attention weights (L, ilen)) a row;
    a row with no frames gives empty tensors."""
    dt = getattr(torch, mc["compute_dtype"])
    hs = encoder(sd, mc, tokens, ilens, pr, dt)
    il = [int(x) for x in ilens]
    if lengths is not None:
        lo = hi = [min(int(n), budget) for n in lengths]
    else:
        lo = [min(int(n * mc["minlenratio"]), budget) for n in il]
        hi = [min(int(n * mc["maxlenratio"]), budget) for n in il]
    rows = [b for b in range(len(il)) if hi[b] > 0 and il[b] > 0]
    out = [(torch.zeros(0, mc["odim"]), torch.zeros(0), torch.zeros(0, n))
           for n in il]
    if not rows:
        return out
    sel = torch.tensor(rows, device=hs.device)
    decoded = decode(sd, mc, hs[sel], [il[b] for b in rows], seed, pr,
                     loop_dtype, [lo[b] for b in rows], [hi[b] for b in rows],
                     fault, row_ids=rows)
    for b, (frames, stops, atts) in zip(rows, decoded):
        L = frames.shape[0]
        before = frames.to(dt)[None]
        mask = torch.ones(1, L, dtype=torch.bool, device=before.device)
        mel = postnet(sd, mc, before, mask, pr) if mc["postnet_layers"] \
            else before
        out[b] = (mel[0].float(), stops, atts)
    return out
