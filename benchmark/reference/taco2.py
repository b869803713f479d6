"""Plain FCL-taco2 inference: text and durations -> mel, in PyTorch ops.

Follows the published model (Tacotron2-SA encoder, variance adaptor with
pitch and energy embeddings, the semi-autoregressive decoder run within
each phoneme, the postnet) with the served model's numerics:

- the ``compute_dtype`` parts (embedding, convolutions, BiLSTM, predictors,
  postnet) in bf16 with fp32 BatchNorm and LayerNorm statistics;
- the decoder loop with its weights in ``loop_dtype`` (fp32 for the
  student, bf16 for the teacher), activations rounded to that type before
  each product, fp32 sums and fp32 LSTM state, zoneout as the
  expectation blend, and the prenet dropout on, drawn as
  ``philox.prenet_keep`` keys it;
- a batch padded to ``Tmax`` tokens (the variance predictors' convolutions
  see the padding, as the served batch's do).

Weights come as a state dict under the model's parameter names.  Nothing
here imports the program.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.philox import prenet_keep
from benchmark.reference.precision import exact_fp32


def conv1d(x, w, b=None):
    """'same' 1-D convolution of channels-last (B, T, C)."""
    pad = (w.shape[-1] - 1) // 2
    return F.conv1d(x.transpose(1, 2), w, b, padding=pad).transpose(1, 2)


def batch_norm(x, sd, pre, eps=1e-5):
    y = (x.float() - sd[pre + "running_mean"].float()) * torch.rsqrt(
        sd[pre + "running_var"].float() + eps)
    return (y * sd[pre + "weight"].float()
            + sd[pre + "bias"].float()).to(x.dtype)


def layer_norm(x, w, b, eps=1e-12):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def lstm_direction(sd, pre, xs, lengths, reverse, pr, dt):
    """One direction of a packed-sequence LSTM over (B, T, in) in ``dt``:
    past a row's length the state holds and the output is zero."""
    w_ih, w_hh = sd[pre + "weight_ih"].to(dt), sd[pre + "weight_hh"].to(dt)
    b_ih, b_hh = sd[pre + "bias_ih"].to(dt), sd[pre + "bias_hh"].to(dt)
    B, T, _ = xs.shape
    H = w_hh.shape[1]
    xproj = F.linear(pr.lo(xs), pr.lo(w_ih), b_ih)
    h = xs.new_zeros(B, H)
    c = xs.new_zeros(B, H)
    valid = torch.arange(T, device=xs.device)[None, :] < lengths[:, None]
    out = xs.new_zeros(B, T, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xproj[:, t] + F.linear(pr.lo(h), pr.lo(w_hh), b_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        v = valid[:, t, None]
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        out[:, t] = torch.where(v, h, torch.zeros_like(h))
    return out


def encoder(sd, mc, tokens, ilens, pr, dt):
    x = sd["encoder.embed.weight"].to(dt)[tokens]
    for i in range(mc["econv_layers"]):
        h = conv1d(pr.lo(x), pr.lo(sd[f"encoder.convs.convs.{i}.weight"]
                                    .to(dt)))
        if mc["use_batch_norm"]:
            h = batch_norm(h, sd, f"encoder.convs.bns.{i}.")
        h = torch.relu(h)
        x = x + h if mc["use_residual"] else h
    for layer in range(mc["elayers"]):
        pre = f"encoder.blstm.{layer}."
        x = torch.cat([lstm_direction(sd, pre + "fwd.", x, ilens, False, pr,
                                      dt),
                       lstm_direction(sd, pre + "bwd.", x, ilens, True, pr,
                                      dt)], dim=-1)
    return x


def variance_predictor(sd, pre, x, pad_mask, n_layers, pr, dt):
    for i in range(n_layers):
        x = torch.relu(conv1d(pr.lo(x), pr.lo(sd[f"{pre}convs.{i}.weight"]
                                               .to(dt)),
                              sd[f"{pre}convs.{i}.bias"].to(dt)))
        x = layer_norm(x, sd[f"{pre}lns.{i}.weight"],
                       sd[f"{pre}lns.{i}.bias"])
    x = F.linear(pr.lo(x), pr.lo(sd[f"{pre}linear.weight"].to(dt)),
                 sd[f"{pre}linear.bias"].to(dt))
    return x.masked_fill(pad_mask[..., None], 0.0)


def scalar_embed(sd, pre, x, pr, dt):
    return conv1d(pr.lo(x), pr.lo(sd[pre + "weight"].to(dt)),
                  sd[pre + "bias"].to(dt))


def segment_plan(durations, max_dur):
    """The batch's B * Tmax token slots in duration-sorted order (stable,
    longest first): (sorted durations, utterance, token, first frame) of
    the slots with frames, each row's place in that order being its
    dropout row."""
    B, T = durations.shape
    d = durations.clamp(0, max_dur).to(torch.int32)
    flat = d.reshape(-1)
    order = torch.argsort(-flat, stable=True)
    dur = flat[order]
    n = int((dur > 0).sum())
    order, dur = order[:n], dur[:n]
    start = (torch.cumsum(d, dim=1) - d).reshape(-1)[order]
    return dur, order // T, order % T, start


def decode(sd, mc, enc_seg, dur, seed, pr, loop_dtype, dt):
    """The AR loop over the sorted segments: (n, S, odim) fp32 frames,
    S the longest duration."""
    dev = enc_seg.device
    idim, U, H = enc_seg.shape[1], mc["prenet_units"], mc["dunits"]
    n = enc_seg.shape[0]
    S = int(dur.max()) if n else 0
    rate, z = mc["dropout_rate"], mc["zoneout_rate"]

    def w(name):
        return pr.loop(sd[name], loop_dtype)

    def act(x):
        return pr.loop(x, loop_dtype)

    wx0 = sd["decoder.lstm.0.weight_ih"].t()
    wx0_enc, wx0_pre = pr.f32(wx0[:idim].to(dt)), pr.loop(
        wx0[idim:idim + U], loop_dtype)
    wx0_pos = wx0[idim + U].to(loop_dtype).float()
    wf = sd["decoder.feat_out.weight"].t()
    wf_z, wf_enc = pr.loop(wf[:H], loop_dtype), pr.f32(wf[H:].to(dt))
    w1 = w("decoder.prenet.layers.0.weight").t()
    w2 = w("decoder.prenet.layers.1.weight").t()
    b1 = sd["decoder.prenet.layers.0.bias"].float()
    b2 = sd["decoder.prenet.layers.1.bias"].float()
    wh0 = w("decoder.lstm.0.weight_hh").t()
    wx1 = w("decoder.lstm.1.weight_ih").t()
    wh1 = w("decoder.lstm.1.weight_hh").t()
    bx0 = sd["decoder.lstm.0.bias_ih"].float()
    bh0 = sd["decoder.lstm.0.bias_hh"].float()
    bx1 = sd["decoder.lstm.1.bias_ih"].float()
    bh1 = sd["decoder.lstm.1.bias_hh"].float()

    d_range = torch.arange(max(S, 1), device=dev)[None, :]
    pos = torch.where(d_range < dur[:, None],
                      d_range.float() / dur[:, None].clamp(min=1).float(),
                      0.0).to(dt).float()
    rows = torch.arange(n, device=dev)
    scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0

    def drop(x, step, layer):
        if rate <= 0:
            return x
        keep = prenet_keep(seed, rate, rows, step, layer, U, device=dev)
        return torch.where(keep, x * scale, torch.zeros_like(x))

    def blend(g, h, c):
        i, f, gg, o = g.chunk(4, dim=-1)
        c_n = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_n = torch.sigmoid(o) * torch.tanh(c_n)
        return z * h + (1 - z) * h_n, z * c + (1 - z) * c_n

    with exact_fp32():
        enc = pr.f32(enc_seg)
        enc_gates = enc @ wx0_enc + bx0
        enc_out = enc @ wf_enc
        h0 = c0 = h1 = c1 = torch.zeros(n, H, device=dev)
        prev = torch.zeros(n, mc["odim"], device=dev)
        outs = torch.zeros(n, S, mc["odim"], device=dev)
        for t in range(S):
            p = drop(torch.relu(act(prev) @ w1 + b1), t, 0)
            p = drop(torch.relu(act(p) @ w2 + b2), t, 1)
            g0 = (enc_gates + (act(p) @ wx0_pre + act(h0) @ wh0)
                  + pos[:, t, None] * wx0_pos + bh0)
            h0, c0 = blend(g0, h0, c0)
            g1 = bx1 + bh1 + (act(h0) @ wx1 + act(h1) @ wh1)
            h1, c1 = blend(g1, h1, c1)
            prev = act(h1) @ wf_z + enc_out
            outs[:, t] = prev
    return outs


def postnet(sd, mc, before, mask, pr):
    x = before
    n = mc["postnet_layers"]
    for i in range(n):
        x = conv1d(pr.lo(x), pr.lo(sd[f"decoder.postnet.convs.{i}.weight"]
                                    .to(x.dtype)))
        if mc["use_batch_norm"]:
            x = batch_norm(x, sd, f"decoder.postnet.bns.{i}.")
        if i < n - 1:
            x = torch.tanh(x)
        x = x * mask[..., None].to(x.dtype)
    return before + x


@torch.no_grad()
def synthesize(sd, mc, tokens, ilens, durations, seed, pr, loop_dtype):
    """tokens (B, Tmax) int (0 pads), ilens (B,), durations (B, Tmax) int
    (0 past ilens), ``seed`` the dropout's seed as an int, ``mc`` the
    model's configuration (the ``model`` group of a configuration file),
    ``loop_dtype`` the decoder loop's weight type.  Returns (mel (B, L,
    odim) fp32 with L the longest utterance's frames, olens (B,))."""
    dt = getattr(torch, mc["compute_dtype"])
    B, T = tokens.shape
    pad_mask = torch.arange(T, device=tokens.device)[None, :] \
        >= ilens[:, None]
    hs = encoder(sd, mc, tokens, ilens, pr, dt)
    d = durations.to(torch.int32).clamp(0, mc["max_dur"]).masked_fill(
        pad_mask, 0)
    if mc["use_fe_condition"]:
        p = variance_predictor(sd, "pitch_predictor.", hs, pad_mask,
                               mc["pitch_predictor_layers"], pr, dt)
        e = variance_predictor(sd, "energy_predictor.", hs, pad_mask,
                               mc["energy_predictor_layers"], pr, dt)
        hs = (hs + scalar_embed(sd, "pitch_embed.", p, pr, dt)
              + scalar_embed(sd, "energy_embed.", e, pr, dt))
    dur, utt, tok, start = segment_plan(d, mc["max_dur"])
    frames = decode(sd, mc, hs[utt, tok], dur, seed, pr, loop_dtype, dt)
    olens = d.sum(dim=1)
    L = int(olens.max())
    before = hs.new_zeros(B, L, mc["odim"])
    S = frames.shape[1]
    frame = torch.arange(S, device=tokens.device)[None, :]
    keep = frame < dur[:, None]
    cols = (start[:, None] + frame)[keep]
    before[utt[:, None].expand(-1, S)[keep], cols] = frames.to(dt)[keep]
    mask = torch.arange(L, device=tokens.device)[None, :] < olens[:, None]
    after = postnet(sd, mc, before, mask, pr) if mc["postnet_layers"] \
        else before
    return (after * mask[..., None].to(after.dtype)).float(), olens
