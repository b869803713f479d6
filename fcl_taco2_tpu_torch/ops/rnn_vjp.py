"""Hand-built backward of the teacher-forced zoneout-LSTM scan, the training
hot path (port of ``fcl_taco2_tpu/ops/rnn_vjp.py``, "strategy B").

- The forward loop saves the ACTIVATED gates and the (h, c) sequences of
  every layer (S·P·6H values a layer, in the compute dtype).
- The backward runs the steps in reverse and carries only (dh, dc) per
  layer; it emits each step's pre-activation gate gradients.
- Every weight gradient is then ONE GEMM over all S·P step rows of the
  saved activations, so no gradient accumulator is touched inside the
  loop.
- ``out = h_last @ wf_z`` is hoisted out of the forward loop (one
  (S·P, H) GEMM over the saved h), and its cotangent out of the backward.

The zoneout keep masks of every step come in as one boolean tensor
``keep`` (S, 2L, P, H), drawn by the caller before the scan
(``models/decoder.py``), and the backward reads the same tensor: nothing
in the scan holds host-side random state, so a CUDA graph of the train
step replays it with fresh masks.  ``decoder_custom_vjp=False`` runs
``scan_plain``: the same step function under autograd, the oracle of this
backward; with ``remat=True`` each of its steps is checkpointed
(``remat_decoder``) and gets its step's masks as an input.

With ``ScanSpec.capture_kd`` both scans also return the per-step
zoneout-blended ``h`` of LSTM layers 0 and 1 (KD knowledge), and the
backward adds their cotangents into each step's ``dh``.

Weights are in PyTorch's layout (``(out, in)``, ``F.linear``); gates are
packed i, f, g, o.  The weights tuple is ``(w_pre (4H, u), w_pos (4H,) or
None, wf_z (W, H), layers)`` with ``layers[0] = (wh0, bh0)`` (layer 0's
input projection is folded into ``enc_gates`` and the prenet term by the
caller) and ``layers[i > 0] = (wx, wh, bx, bh)``.

Both scans' forward and backward each run inside a span
(``SCAN_RANGES``, ``utils/spans.py``): a profiler trace of an eager step
splits the device time by the ranges' launches, and a graphed step's
marks split each replay.  The plain scan's backward is spanned by
``backward_span`` at its activation inputs and its outputs; with
``remat`` the recomputed steps run inside it.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from fcl_taco2_tpu_torch.utils.spans import backward_span, span

SCAN_RANGES = ("scan.fwd", "scan.bwd")


class ScanSpec(NamedTuple):
    """Static configuration of one teacher-forced scan
    (``rnn_vjp.py:44-58``)."""
    dlayers: int
    dunits: int
    zoneout_rate: float
    train: bool
    append_position: bool
    use_enc_out: bool  # enc_out operand present (cfg.use_concate)
    capture_kd: bool = False  # also return h of layers 0 and 1, (S, P, H)


def step_forward(spec, weights, enc_gates, hs, cs, prenet_t, pos_t, keep,
                 save_gates=False):
    """One step of the stack (``rnn_vjp.py:102-144``).  Returns
    (new_hs, new_cs, activated gates per layer or None)."""
    w_pre, w_pos, _, layers = weights
    xproj = enc_gates + F.linear(prenet_t, w_pre)
    if spec.append_position:
        xproj = xproj + pos_t[:, None] * w_pos
    r = spec.zoneout_rate
    new_hs, new_cs, gates_out = [], [], []
    x = None  # layer i>0 input = h_new of layer i-1
    for i in range(spec.dlayers):
        if i == 0:
            wh, bh = layers[0]
            pre = xproj + F.linear(hs[0], wh, bh)
        else:
            wx, wh, bx, bh = layers[i]
            pre = F.linear(x, wx, bx) + F.linear(hs[i], wh, bh)
        ig, fg, gg, og = pre.chunk(4, dim=-1)
        ig, fg = torch.sigmoid(ig), torch.sigmoid(fg)
        gg, og = torch.tanh(gg), torch.sigmoid(og)
        c_cand = fg * cs[i] + ig * gg
        h_cand = og * torch.tanh(c_cand)
        if keep is not None:
            h_new = torch.where(keep[2 * i], hs[i], h_cand)
            c_new = torch.where(keep[2 * i + 1], cs[i], c_cand)
        elif not spec.train and r > 0.0:
            h_new = r * hs[i] + (1.0 - r) * h_cand
            c_new = r * cs[i] + (1.0 - r) * c_cand
        else:
            h_new, c_new = h_cand, c_cand
        if save_gates:
            gates_out.append(torch.cat([ig, fg, gg, og], dim=-1))
        new_hs.append(h_new)
        new_cs.append(c_new)
        x = h_new
    return new_hs, new_cs, (gates_out if save_gates else None)


def _feat_out(spec, h_last, wf_z, enc_out):
    """The hoisted feat_out over all steps: (S, P, H) -> (S, P, W)."""
    outs = F.linear(h_last, wf_z)
    if spec.use_enc_out:
        outs = outs + enc_out
    return outs


def _keep(spec, keep, s):
    """Step ``s``'s (2L, P, H) masks in train mode, else None."""
    if not (spec.train and spec.zoneout_rate > 0.0) or keep is None:
        return None
    return keep[s]


def scan_plain(spec, weights, enc_gates, enc_out, prenet_steps, pos_steps,
               keep, remat=False):
    """The scan as plain PyTorch ops, differentiated by autograd: the
    oracle of ``zoneout_lstm_scan``'s hand-built backward, and the same
    forward math op for op (``models/decoder.py:360-380``).

    ``remat``: each step runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` on the autodiff scan step,
    ``decoder.py:373-377``), so the backward recomputes a step's
    activations from its carry instead of keeping them; its masks are one
    of its inputs, so the recomputation blends with the same masks.
    Returns outs (S, P, W), and with ``spec.capture_kd`` also
    the h of layers 0 and 1, (S, P, H) each."""
    with span(SCAN_RANGES[0]):
        return _scan_plain(spec, weights, enc_gates, enc_out, prenet_steps,
                           pos_steps, keep, remat)


def _scan_plain(spec, weights, enc_gates, enc_out, prenet_steps, pos_steps,
                keep, remat):
    L, H = spec.dlayers, spec.dunits
    S, P = prenet_steps.shape[0], enc_gates.shape[0]
    # the span's identity takes the activations only: ``enc_gates`` enters
    # every step, so the span still closes after the whole backward, and
    # each weight's per-step gradients still add up in one buffer with
    # those of the other scans that share it (the duration classes), in
    # the order an unspanned scan adds them (through an identity they
    # would be summed per scan first, another bf16 rounding)
    bwd = backward_span(SCAN_RANGES[1])
    enc_gates, enc_out, prenet_steps, pos_steps = bwd.inputs(
        enc_gates, enc_out, prenet_steps, pos_steps)

    def step(keep_s, prenet_t, pos_t, *carry):
        hs, cs, _ = step_forward(spec, weights, enc_gates, carry[:L],
                                 carry[L:], prenet_t, pos_t, keep_s)
        return (*hs, *cs)

    if remat and torch.is_grad_enabled():
        plain_step = step

        def step(*args):
            return torch.utils.checkpoint.checkpoint(
                plain_step, *args, use_reentrant=False,
                preserve_rng_state=False)

    carry = [enc_gates.new_zeros(P, H) for _ in range(2 * L)]
    h_steps = [[] for _ in range(L)]
    for s in range(S):
        carry = step(_keep(spec, keep, s), prenet_steps[s],
                     None if pos_steps is None else pos_steps[s], *carry)
        for i in range(L):
            h_steps[i].append(carry[i])
    outs = _feat_out(spec, torch.stack(h_steps[L - 1]), weights[2], enc_out)
    if spec.capture_kd:
        return bwd.outputs(outs, torch.stack(h_steps[0]),
                           torch.stack(h_steps[1]))
    return bwd.outputs(outs)[0]


class _ZoneoutLSTMScan(torch.autograd.Function):
    """Forward saves gates and (h, c); backward is the reverse loop over
    (dh, dc) plus post-loop weight GEMMs (``rnn_vjp.py:147-311``)."""

    @staticmethod
    def forward(ctx, *args):
        with span(SCAN_RANGES[0]):
            return _ZoneoutLSTMScan._forward(ctx, *args)

    @staticmethod
    def backward(ctx, *cotangents):
        with span(SCAN_RANGES[1]):
            return _ZoneoutLSTMScan._backward(ctx, *cotangents)

    @staticmethod
    def _forward(ctx, spec, keep, enc_gates, enc_out, prenet_steps,
                pos_steps, w_pre, w_pos, wf_z, *layer_flat):
        L, H = spec.dlayers, spec.dunits
        S, P = prenet_steps.shape[0], enc_gates.shape[0]
        layers = _unflatten_layers(layer_flat)
        weights = (w_pre, w_pos, wf_z, layers)
        new = enc_gates.new_empty
        gates_all = [new(S, P, 4 * H) for _ in range(L)]
        h_all = [new(S, P, H) for _ in range(L)]
        c_all = [new(S, P, H) for _ in range(L)]
        hs = [enc_gates.new_zeros(P, H) for _ in range(L)]
        cs = [enc_gates.new_zeros(P, H) for _ in range(L)]
        for s in range(S):
            hs, cs, gates = step_forward(
                spec, weights, enc_gates, hs, cs, prenet_steps[s],
                None if pos_steps is None else pos_steps[s],
                _keep(spec, keep, s), save_gates=True)
            for i in range(L):
                gates_all[i][s] = gates[i]
                h_all[i][s] = hs[i]
                c_all[i][s] = cs[i]
        outs = _feat_out(spec, h_all[L - 1], wf_z, enc_out)
        ctx.spec = spec
        ctx.has_pos = pos_steps is not None
        ctx.has_enc_out = enc_out is not None
        ctx.save_for_backward(
            keep, prenet_steps, pos_steps if ctx.has_pos else None, w_pre,
            w_pos if ctx.has_pos else None, wf_z, *layer_flat,
            *gates_all, *h_all, *c_all)
        if spec.capture_kd:
            return outs, h_all[0], h_all[1]
        return outs

    @staticmethod
    def _backward(ctx, douts, *dcapture):
        spec = ctx.spec
        L, H = spec.dlayers, spec.dunits
        keep_all, *saved = ctx.saved_tensors
        prenet_steps, pos_steps, w_pre, w_pos, wf_z = saved[:5]
        n_flat = 2 + 4 * (L - 1)
        layers = _unflatten_layers(saved[5:5 + n_flat])
        rest = saved[5 + n_flat:]
        gates_all, h_all, c_all = rest[:L], rest[L:2 * L], rest[2 * L:]
        S, P = prenet_steps.shape[0], gates_all[0].shape[1]
        dtype = gates_all[0].dtype
        douts = douts.to(dtype)
        # cotangents of the captured h of layers 0 and 1 (capture_kd)
        dz = [d.to(dtype) for d in dcapture]

        # hoisted cotangents of the post-loop feat_out GEMM
        h_last = h_all[L - 1]
        d_wf_z = douts.reshape(S * P, -1).t() @ h_last.reshape(S * P, H)
        d_enc_out = douts.sum(0) if ctx.has_enc_out else None
        dh_direct = douts @ wf_z  # (S, P, H)

        use_zo = spec.zoneout_rate > 0.0
        r = spec.zoneout_rate
        dgates_all = [torch.empty_like(g) for g in gates_all]
        dhs = [douts.new_zeros(P, H) for _ in range(L)]
        dcs = [douts.new_zeros(P, H) for _ in range(L)]
        for s in reversed(range(S)):
            keep = _keep(spec, keep_all, s)
            dx = None  # cotangent from layer i+1's input into h_new[i]
            for i in reversed(range(L)):
                dh_new = dhs[i]
                if i == L - 1:
                    dh_new = dh_new + dh_direct[s]
                if dx is not None:
                    dh_new = dh_new + dx
                if i < len(dz):
                    dh_new = dh_new + dz[i][s]
                dc_new = dcs[i]
                if keep is not None:
                    kh, kc = keep[2 * i], keep[2 * i + 1]
                    zero = dh_new.new_zeros(())
                    dh_cand = torch.where(kh, zero, dh_new)
                    dh_prev = torch.where(kh, dh_new, zero)
                    dc_cand = torch.where(kc, zero, dc_new)
                    dc_prev = torch.where(kc, dc_new, zero)
                elif not spec.train and use_zo:
                    dh_cand, dh_prev = (1.0 - r) * dh_new, r * dh_new
                    dc_cand, dc_prev = (1.0 - r) * dc_new, r * dc_new
                else:
                    dh_cand, dh_prev = dh_new, None
                    dc_cand, dc_prev = dc_new, None
                ig, fg, gg, og = gates_all[i][s].chunk(4, dim=-1)
                if s > 0:
                    c_prev = c_all[i][s - 1]
                    tc = torch.tanh(fg * c_prev + ig * gg)
                else:  # zero initial state
                    c_prev = None
                    tc = torch.tanh(ig * gg)
                do = dh_cand * tc
                dc_cand = dc_cand + dh_cand * og * (1.0 - tc * tc)
                di = dc_cand * gg
                df = (dc_cand * c_prev if c_prev is not None
                      else torch.zeros_like(dc_cand))
                dg = dc_cand * ig
                dc_carry = dc_cand * fg
                dc_prev = dc_carry if dc_prev is None else dc_prev + dc_carry
                dpre = torch.cat(
                    [di * ig * (1.0 - ig), df * fg * (1.0 - fg),
                     dg * (1.0 - gg * gg), do * og * (1.0 - og)], dim=-1)
                wh = layers[0][0] if i == 0 else layers[i][1]
                dh_rec = dpre @ wh
                dh_prev = dh_rec if dh_prev is None else dh_prev + dh_rec
                dx = (dpre @ layers[i][0]) if i > 0 else None
                dhs[i], dcs[i] = dh_prev, dc_prev
                dgates_all[i][s] = dpre

        # ---- post-loop weight gradients: one GEMM each over S·P rows ----
        def rows(t):
            return t.reshape(-1, t.shape[-1])

        dg0 = dgates_all[0]
        d_w_pre = rows(dg0).t() @ rows(prenet_steps)
        d_prenet = dg0 @ w_pre
        d_enc_gates = dg0.sum(0)
        d_w_pos = d_pos = None
        if ctx.has_pos:
            d_w_pos = (pos_steps.reshape(1, -1) @ rows(dg0)).reshape(-1)
            d_pos = dg0 @ w_pos
        d_layers = []
        for i in range(L):
            dg = dgates_all[i]
            # h_prev of step 0 is zero: the recurrent GEMM covers steps 1..S-1
            d_wh = rows(dg[1:]).t() @ rows(h_all[i][:-1])
            d_b = dg.sum((0, 1))
            if i == 0:
                d_layers += [d_wh, d_b]
            else:
                d_wx = rows(dg).t() @ rows(h_all[i - 1])
                d_layers += [d_wx, d_wh, d_b, d_b]
        return (None, None, d_enc_gates, d_enc_out, d_prenet, d_pos,
                d_w_pre, d_w_pos, d_wf_z, *d_layers)


def _unflatten_layers(flat):
    layers = [tuple(flat[:2])]
    for j in range(2, len(flat), 4):
        layers.append(tuple(flat[j:j + 4]))
    return layers


def zoneout_lstm_scan(spec, weights, enc_gates, enc_out, prenet_steps,
                      pos_steps, keep):
    """Teacher-forced scan of a ``spec.dlayers``-deep zoneout-LSTM stack
    with the hand-built backward (``rnn_vjp.py:84-99``).

    Args:
        weights: see the module docstring.
        enc_gates: (P, 4H) step-invariant layer-0 gate term
            ``enc_seg @ w_enc^T + bias_ih0``.
        enc_out: (P, W) step-invariant feat_out term, or None.
        prenet_steps: (S, P, u) per-step prenet outputs (step-major).
        pos_steps: (S, P) position scalars, or None.
        keep: (S, 2L, P, H) boolean zoneout keep-old masks, [2i] for h
            and [2i+1] for c of layer i (used in train mode with
            zoneout_rate > 0), or None.
    Returns outs (S, P, W), and with ``spec.capture_kd`` also the
    zoneout-blended h of layers 0 and 1, (S, P, H) each
    (``rnn_vjp.py:178``).
    """
    w_pre, w_pos, wf_z, layers = weights
    flat = [t for layer in layers for t in layer]
    return _ZoneoutLSTMScan.apply(
        spec, keep, enc_gates, enc_out if spec.use_enc_out else None,
        prenet_steps, pos_steps if spec.append_position else None, w_pre,
        w_pos if spec.append_position else None, wf_z, *flat)
