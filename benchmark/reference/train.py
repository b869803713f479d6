"""Plain FCL-taco2 training: the loss of one batch, its gradients by
autograd, global-norm clipping and Adam, in PyTorch ops.

The loss follows the published model in train mode (encoder convolutions
with masked batch statistics and dropout, the duration, pitch and energy
predictors with their dropouts, the pitch and energy embeddings from the
targets, the teacher-forced decoder over duration classes with prenet
dropout and zoneout masks, the postnet with masked batch statistics and
dropout; L1 + MSE of the mel before and after the postnet, the duration
loss in the log domain, MSE of pitch and energy) at the served numerics:
bf16 products, fp32 statistics and losses.

Every dropout and zoneout mask is a draw from the step's generator in the
order the served step draws them, with the shapes of its static batch:
``Tmax`` tokens, ``Lmax`` frames and, for each duration class, its
capacity of segments, from which the segments take rows in
utterance-major order (``classed_plan``, a frozen copy of the served plan
builder's rules).  So the reference and the served step see the same
masks.  Nothing here imports the program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.taco2 import conv1d, layer_norm

B1, B2 = 0.9, 0.999


# ---------------------------------------------------------------- plans


def round_up(x, m):
    return int(math.ceil(max(x, 1) / m) * m)


def class_caps(per_utt_durations, class_durs, batch_size, bucket=64):
    """Each class's capacity: the sum of the ``batch_size`` largest
    per-utterance counts of segments whose first-fitting class it is,
    rounded up to ``bucket``."""
    edges = np.asarray(class_durs)
    counts = np.asarray([np.bincount(
        np.searchsorted(edges, d[d > 0], "left"), minlength=len(edges))
        for d in map(np.asarray, per_utt_durations)])
    return tuple(round_up(int(np.sort(counts[:, c])[::-1][:batch_size]
                              .sum()), bucket)
                 for c in range(len(edges)))


def classed_plan(durations, class_durs, caps, Lmax):
    """(B, Tmax) durations -> per class (seg_utt, seg_tok, seg_start,
    seg_dur) of ``caps[c]`` rows (padding rows zero), and (B, Lmax) the
    flat index of each frame into the classes' concatenated (P_c * D_c)
    frames.  A segment joins the first class whose duration fits it; the
    last arrivals of a full class move up to the next."""
    durations = np.asarray(durations, np.int64)
    B = durations.shape[0]
    utt, tok = np.nonzero(durations > 0)
    dur = durations[utt, tok]
    start = (np.cumsum(durations, axis=1) - durations)[utt, tok]
    base = np.searchsorted(np.asarray(class_durs), dur, "left")
    members, pool = [], np.zeros(0, np.int64)
    for c in range(len(class_durs)):
        idx = np.concatenate([pool, np.nonzero(base == c)[0]])
        idx, pool = idx[:caps[c]], idx[caps[c]:]
        members.append(np.sort(idx))
    if len(pool):
        raise ValueError("segments overflow the class capacities")
    classes, gather, off = [], np.zeros((B, Lmax), np.int64), 0
    for c, idx in enumerate(members):
        rows = [np.zeros(caps[c], np.int64) for _ in range(4)]
        for r, v in zip(rows, (utt, tok, start, dur)):
            r[:len(idx)] = v[idx]
        classes.append(rows)
        for j, s in enumerate(idx):
            gather[utt[s], start[s]:start[s] + dur[s]] = \
                off + j * class_durs[c] + np.arange(dur[s])
        off += caps[c] * class_durs[c]
    return classes, gather


# ---------------------------------------------------------------- loss


def dropout(x, rate, gen):
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def batch_norm_train(x, w, b, mask, eps=1e-5):
    """Masked batch statistics over (B, T); output in x's dtype."""
    x32 = x.float()
    m = mask.float()[..., None]
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x32 * m).sum(dim=(0, 1)) / n
    var = ((x32 - mean).square() * m).sum(dim=(0, 1)) / n
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def lstm_direction(p, pre, xs, lengths, reverse, pr):
    w_ih, w_hh = p[pre + "weight_ih"], p[pre + "weight_hh"]
    B, T, _ = xs.shape
    H = w_hh.shape[1]
    xproj = F.linear(pr.lo(xs), pr.lo(w_ih), p[pre + "bias_ih"])
    h = c = xs.new_zeros(B, H)
    valid = torch.arange(T, device=xs.device)[None, :] < lengths[:, None]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = xproj[:, t] + F.linear(pr.lo(h), pr.lo(w_hh), p[pre + "bias_hh"])
        i, f, gg, o = g.chunk(4, dim=-1)
        c_n = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_n = torch.sigmoid(o) * torch.tanh(c_n)
        v = valid[:, t, None]
        h, c = torch.where(v, h_n, h), torch.where(v, c_n, c)
        outs[t] = torch.where(v, h, torch.zeros_like(h))
    return torch.stack(outs, dim=1)


def predictor(p, pre, x, n_layers, rate, gen, pr):
    for i in range(n_layers):
        x = torch.relu(conv1d(pr.lo(x), pr.lo(p[f"{pre}convs.{i}.weight"]),
                              p[f"{pre}convs.{i}.bias"]))
        x = layer_norm(x, p[f"{pre}lns.{i}.weight"], p[f"{pre}lns.{i}.bias"])
        x = dropout(x, rate, gen)
    return F.linear(pr.lo(x), pr.lo(p[f"{pre}linear.weight"]),
                    p[f"{pre}linear.bias"])


def decoder_class(p, mc, enc, tgt, pos, gen, pr):
    """One class's teacher-forced pass: (P, D, odim) frames, and the
    knowledge a distillation reads: the prenet's output and each step's h
    of both LSTM layers (P, D, width)."""
    P, D, odim = tgt.shape
    H, U, rate = mc["dunits"], mc["prenet_units"], mc["dropout_rate"]
    prev = torch.cat([tgt.new_zeros(P, 1, odim), tgt[:, :-1]], dim=1)
    x = prev.reshape(P * D, odim)
    for i in range(mc["prenet_layers"]):
        x = dropout(torch.relu(F.linear(
            pr.lo(x), pr.lo(p[f"decoder.prenet.layers.{i}.weight"]),
            p[f"decoder.prenet.layers.{i}.bias"])), rate, gen)
    prenet_out = x.reshape(P, D, U)
    pre_steps = prenet_out.transpose(0, 1)
    pos_steps = pos.t()
    idim = enc.shape[1]
    w0 = p["decoder.lstm.0.weight_ih"]
    w_enc, w_pre, w_pos = w0[:, :idim], w0[:, idim:idim + U], w0[:, idim + U]
    wf = p["decoder.feat_out.weight"]
    enc_gates = F.linear(pr.lo(enc), pr.lo(w_enc), p["decoder.lstm.0.bias_ih"])
    enc_out = F.linear(pr.lo(enc), pr.lo(wf[:, H:]))
    keep = torch.rand((D, 4, P, H), generator=gen, device=enc.device) \
        < mc["zoneout_rate"]
    hs = [enc.new_zeros(P, H), enc.new_zeros(P, H)]
    cs = [enc.new_zeros(P, H), enc.new_zeros(P, H)]
    h_steps = ([], [])
    for s in range(D):
        xproj = enc_gates + F.linear(pr.lo(pre_steps[s]), pr.lo(w_pre))
        xproj = xproj + pos_steps[s][:, None] * w_pos
        inp = None
        for i in range(2):
            pre = f"decoder.lstm.{i}."
            g = F.linear(pr.lo(hs[i]), pr.lo(p[pre + "weight_hh"]),
                         p[pre + "bias_hh"])
            g = xproj + g if i == 0 else F.linear(
                pr.lo(inp), pr.lo(p[pre + "weight_ih"]),
                p[pre + "bias_ih"]) + g
            ig, fg, gg, og = g.chunk(4, dim=-1)
            ig, fg = torch.sigmoid(ig), torch.sigmoid(fg)
            gg, og = torch.tanh(gg), torch.sigmoid(og)
            c_c = fg * cs[i] + ig * gg
            h_c = og * torch.tanh(c_c)
            hs[i] = torch.where(keep[s, 2 * i], hs[i], h_c)
            cs[i] = torch.where(keep[s, 2 * i + 1], cs[i], c_c)
            inp = hs[i]
            h_steps[i].append(hs[i])
    outs = F.linear(pr.lo(torch.stack(h_steps[1])), pr.lo(wf[:, :H])) \
        + enc_out
    return (outs.transpose(0, 1), prenet_out,
            torch.stack(h_steps[0]).transpose(0, 1),
            torch.stack(h_steps[1]).transpose(0, 1))


def masked_mean(v, mask):
    m = torch.broadcast_to(mask, v.shape).to(v.dtype)
    return (v * m).sum() / torch.clamp(m.sum(), min=1.0)


def loss_fn(master, mc, batch, gen, pr, rows=None):
    """The training loss of ``batch`` (a dict of tensors: tokens, ilens,
    mel, olens, durations, f0, energy, ``classes`` (per class: seg_utt,
    seg_tok, seg_start, seg_dur, D) and gather) with ``master`` the fp32
    parameters.  Returns (loss, report, knowledge): the knowledge a
    distillation compares, in the compute type (``after``, ``before``,
    ``encoder`` [embed, convs.., blstm], ``decoder`` [prenet, lstm0,
    lstm1, postnet layers..] and ``prosody`` [durations, pitch, energy,
    pitch embedding, energy embedding]).  ``rows``: a (B,) bool mask of
    the utterances the loss's means cover (a fault the check must catch:
    half of the batch left out), all of them by default."""
    dt = getattr(torch, mc["compute_dtype"])
    p = {k: v.to(dt) for k, v in master.items()}
    mel, f0, en = (batch[k].to(dt) for k in ("mel", "f0", "energy"))
    tokens, ilens, olens = batch["tokens"], batch["ilens"], batch["olens"]
    B, T = tokens.shape
    L = mel.shape[1]
    dev = tokens.device
    seq_mask = torch.arange(T, device=dev)[None, :] < ilens[:, None]
    rate = mc["dropout_rate"]

    x = p["encoder.embed.weight"][tokens]
    enc_know = [x]
    for i in range(mc["econv_layers"]):
        h = conv1d(pr.lo(x), pr.lo(p[f"encoder.convs.convs.{i}.weight"]))
        h = batch_norm_train(h, p[f"encoder.convs.bns.{i}.weight"],
                             p[f"encoder.convs.bns.{i}.bias"], seq_mask)
        x = dropout(torch.relu(h), rate, gen)
        enc_know.append(x)
    for layer in range(mc["elayers"]):
        pre = f"encoder.blstm.{layer}."
        x = torch.cat([lstm_direction(p, pre + "fwd.", x, ilens, False, pr),
                       lstm_direction(p, pre + "bwd.", x, ilens, True, pr)],
                      dim=-1)
    hs = x
    enc_know.append(x)
    pad = ~seq_mask
    d_outs = predictor(p, "duration_predictor.", hs,
                       mc["duration_predictor_layers"],
                       mc["duration_predictor_dropout_rate"], gen,
                       pr)[..., 0].masked_fill(pad, 0.0)
    p_outs = predictor(p, "pitch_predictor.", hs,
                       mc["pitch_predictor_layers"],
                       mc["pitch_predictor_dropout_rate"], gen,
                       pr).masked_fill(pad[..., None], 0.0)
    e_outs = predictor(p, "energy_predictor.", hs,
                       mc["energy_predictor_layers"],
                       mc["energy_predictor_dropout_rate"], gen,
                       pr).masked_fill(pad[..., None], 0.0)
    p_embs = dropout(conv1d(pr.lo(f0), pr.lo(p["pitch_embed.weight"]),
                            p["pitch_embed.bias"]),
                     mc["pitch_embed_dropout_rate"], gen)
    e_embs = dropout(conv1d(pr.lo(en), pr.lo(p["energy_embed.weight"]),
                            p["energy_embed.bias"]),
                     mc["energy_embed_dropout_rate"], gen)
    hs_cond = hs + p_embs + e_embs

    flats = [[], [], [], []]
    for seg_utt, seg_tok, seg_start, seg_dur, D in batch["classes"]:
        d = torch.arange(D, device=dev)
        fmask = d[None, :] < seg_dur[:, None]
        cols = torch.clamp(seg_start[:, None] + d[None, :], max=L - 1)
        tgt = mel[seg_utt[:, None], cols] * fmask[..., None].to(dt)
        pos = torch.where(fmask, d.float()[None, :]
                          / torch.clamp(seg_dur, min=1).float()[:, None],
                          0.0).to(dt)
        for f, item in zip(flats, decoder_class(
                p, mc, hs_cond[seg_utt, seg_tok], tgt, pos, gen, pr)):
            f.append(item.reshape(-1, item.shape[-1]))
    out_mask = torch.arange(L, device=dev)[None, :] < olens[:, None]
    before, *dec_know = [torch.cat(f)[batch["gather"]]
                         * out_mask[..., None].to(dt) for f in flats]
    y = before
    n = mc["postnet_layers"]
    for i in range(n):
        y = conv1d(pr.lo(y), pr.lo(p[f"decoder.postnet.convs.{i}.weight"]))
        y = batch_norm_train(y, p[f"decoder.postnet.bns.{i}.weight"],
                             p[f"decoder.postnet.bns.{i}.bias"], out_mask)
        if i < n - 1:
            y = torch.tanh(y)
        y = dropout(y, rate, gen) * out_mask[..., None].to(dt)
        dec_know.append(y)
    after = before + y
    know = {"after": after, "before": before, "encoder": enc_know,
            "decoder": dec_know,
            "prosody": [d_outs[..., None], p_outs, e_outs, p_embs, e_embs]}

    # the targets as the served step reads them: cast to the compute type
    keep = torch.ones(B, dtype=torch.bool, device=dev) if rows is None \
        else rows
    mel32, om = mel.float(), (out_mask & keep[:, None])[..., None]
    in_mask = seq_mask & keep[:, None]
    after, before = after.float(), before.float()
    l1 = masked_mean((after - mel32).abs(), om) + \
        masked_mean((before - mel32).abs(), om)
    mse = masked_mean((after - mel32).square(), om) + \
        masked_mean((before - mel32).square(), om)
    target = torch.log(batch["durations"].float()
                       + mc["duration_predictor_offset"])
    dur = masked_mean((d_outs.float() - target).square(), in_mask)
    pitch = masked_mean((p_outs.float() - f0.float()).square(),
                        in_mask[..., None])
    energy = masked_mean((e_outs.float() - en.float()).square(),
                         in_mask[..., None])
    loss = l1 + mse + dur + pitch + energy
    return loss, {"l1_loss": l1, "mse_loss": mse, "dur_loss": dur,
                  "pitch_loss": pitch, "energy_loss": energy,
                  "loss": loss}, know


def kd_loss_fn(student, teacher, smc, tmc, batch, gen, pr, rows=None):
    """The distillation loss: the frozen teacher's train-mode forward
    draws first from ``gen``, the student's continues from the state it
    leaves; the student's own loss plus L1 + MSE of the student's mel
    against the teacher's (before and after the postnet) and the MSEs of
    the encoder, decoder and prosody knowledge, the student's widened by
    its shared fp32 projections (``kd_proj.*``; the postnet's last layer
    and the first three prosody items compared as they are)."""
    with torch.no_grad():
        _, _, tk = loss_fn(teacher, tmc, batch, gen, pr)
    loss, report, sk = loss_fn(
        {k: v for k, v in student.items() if not k.startswith("kd_proj.")},
        smc, batch, gen, pr, rows)
    B, T = batch["tokens"].shape
    L = batch["mel"].shape[1]
    dev = batch["tokens"].device
    keep = torch.ones(B, dtype=torch.bool, device=dev)[:, None] \
        if rows is None else rows[:, None]
    in_mask = ((torch.arange(T, device=dev)[None, :]
                < batch["ilens"][:, None]) & keep)[..., None]
    out_mask = ((torch.arange(L, device=dev)[None, :]
                 < batch["olens"][:, None]) & keep)[..., None]

    def proj(name, x):
        return F.linear(pr.f32(x), pr.f32(student[f"kd_proj.{name}.weight"]))

    def mse(items, targets, mask):
        return sum(masked_mean((a.float() - b.float()).square(), mask)
                   for a, b in zip(items, targets))

    sa, ta = sk["after"].float(), tk["after"].float()
    sb, tb = sk["before"].float(), tk["before"].float()
    s_embed, *s_convs, s_blstm = sk["encoder"]
    s_pre, s_l0, s_l1, *s_post = sk["decoder"]
    s_d, s_p, s_e, s_pe, s_ee = sk["prosody"]
    terms = {
        "output_l1_loss": masked_mean((sa - ta).abs(), out_mask)
        + masked_mean((sb - tb).abs(), out_mask),
        "output_mse_loss": masked_mean((sa - ta).square(), out_mask)
        + masked_mean((sb - tb).square(), out_mask),
        "encoder_loss": mse([proj("embed", s_embed)]
                            + [proj("convs.0", c) for c in s_convs]
                            + [proj("blstm", s_blstm)], tk["encoder"],
                            in_mask),
        "decoder_loss": mse([proj("prenet", s_pre), proj("lstm.0", s_l0),
                             proj("lstm.0", s_l1)]
                            + [proj("post.0", y) for y in s_post[:-1]]
                            + [s_post[-1]], tk["decoder"], out_mask),
        "prosody_loss": mse([s_d, s_p, s_e, proj("pemb", s_pe),
                             proj("eemb", s_ee)], tk["prosody"], in_mask)}
    for name, term in terms.items():
        loss = loss + term
        report[name] = term
    report["loss"] = loss
    return loss, report


def adam_step(master, grads, state, lr, eps, clip):
    """One update in place: skipped where a gradient is not finite; the
    gradients clipped to global norm ``clip``; Adam with the bias
    corrections and ``eps`` outside the root.  Returns the gradients as
    the update saw them."""
    if not all(torch.isfinite(g).all() for g in grads.values()):
        return None
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = 1.0 if norm < clip else clip / norm
    state["t"] += 1
    t = state["t"]
    seen = {}
    with torch.no_grad():
        for k, g in grads.items():
            g = g * scale
            seen[k] = g
            mu = state["mu"][k] = B1 * state["mu"][k] + (1 - B1) * g
            nu = state["nu"][k] = B2 * state["nu"][k] + (1 - B2) * g * g
            upd = (mu / (1 - B1 ** t)) / (torch.sqrt(nu / (1 - B2 ** t))
                                          + eps)
            master[k] -= lr * upd
    return seen
