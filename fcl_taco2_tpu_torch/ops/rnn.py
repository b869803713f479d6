"""LSTM primitives (port of ``fcl_taco2_tpu/ops/rnn.py``).

A cell's parameters are an ``nn.LSTMCell`` (``weight_ih`` (4H, in),
``weight_hh`` (4H, H), ``bias_ih``, ``bias_hh``; gates packed i, f, g, o),
used as a container: the math is written out so the input projection can
be hoisted out of the time loop as one GEMM.
"""

import torch
import torch.nn.functional as F


def lstm_cell(params, x, h, c, *, precomputed_xproj=None):
    """One LSTM step (``ops/rnn.py:38-59``).  ``precomputed_xproj`` is
    ``x @ W_ih^T + b_ih``, hoisted by the caller."""
    if precomputed_xproj is None:
        gates = F.linear(x, params.weight_ih, params.bias_ih) \
            + F.linear(h, params.weight_hh, params.bias_hh)
    else:
        gates = precomputed_xproj + F.linear(h, params.weight_hh,
                                             params.bias_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


_MASK64 = (1 << 64) - 1


def step_seed(base, *path):
    """A 63-bit seed mixed from ``base`` and the integers in ``path``
    (splitmix64 finalizer): the seed of a train step's generator is
    ``step_seed(seed, step)``, so a step's draws depend on
    ``(seed, step)`` alone."""
    z = base & _MASK64
    for p in path:
        z = (z + 0x9E3779B97F4A7C15 * (int(p) + 1)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def prenet_dropout(x, rate, generator):
    """Inverted dropout drawn from ``generator`` (torch ``F.dropout``
    parity: keep with probability 1-rate, scale kept values by
    1/(1-rate)); the plain versions' prenet dropout and every train-mode
    dropout (``models/components.py``)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def zoneout_keep_masks(gen, seed, n, P, H, rate):
    """Keep-old Bernoulli(``rate``) masks (``ops/rnn.py:62-82``) of shape
    (n, P, H), or (*n, P, H) for a tuple ``n``, in one draw from ``gen``,
    a ``torch.Generator`` on the masks' device.  With an int ``seed`` the
    generator is re-seeded first, so the masks depend on ``seed`` only;
    with ``seed=None`` they are the generator's next draw, which keeps
    the call free of host state (a CUDA graph replays it with the seed
    the generator holds at replay).  Torch's Philox stream cannot match
    JAX's RBG or threefry bits; the keep rate is what matches."""
    if seed is not None:
        gen.manual_seed(seed)
    shape = (n, P, H) if isinstance(n, int) else (*n, P, H)
    return torch.rand(shape, generator=gen, device=gen.device) < rate


def zoneout(old, new, rate, keep=None):
    """Zoneout state blend (``ops/rnn.py:85-100``): with a boolean ``keep``
    mask (train) the old state where it is True; without one (eval) the
    expectation blend ``rate*old + (1-rate)*new``."""
    if rate <= 0.0:
        return new
    if keep is not None:
        return torch.where(keep, old, new)
    return rate * old + (1.0 - rate) * new


def lstm_scan(params, xs, lengths=None, reverse=False):
    """LSTM over (B, T, in) with packed-sequence semantics
    (``ops/rnn.py:103-155``): past a row's length the state is frozen and
    the output is zero, so the reverse direction sees only each row's
    valid suffix.  Returns ((B, T, H) outputs, (h, c))."""
    B, T, _ = xs.shape
    H = params.weight_hh.shape[1]
    h = xs.new_zeros(B, H)
    c = xs.new_zeros(B, H)
    xproj = F.linear(xs, params.weight_ih, params.bias_ih)  # hoisted
    valid = None
    if lengths is not None:
        valid = (torch.arange(T, device=xs.device)[None, :]
                 < lengths[:, None].to(xs.device))  # (B, T)
    outs = [None] * T
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        h_new, c_new = lstm_cell(params, None, h, c,
                                 precomputed_xproj=xproj[:, t])
        if valid is None:
            outs[t] = h_new
        else:
            v = valid[:, t, None]
            h_new = torch.where(v, h_new, h)
            c_new = torch.where(v, c_new, c)
            outs[t] = torch.where(v, h_new, torch.zeros_like(h_new))
        h, c = h_new, c_new
    return torch.stack(outs, dim=1), (h, c)


def bilstm(params_fwd, params_bwd, xs, lengths):
    """Bidirectional LSTM, outputs concatenated (``ops/rnn.py:158-166``)."""
    out_f, _ = lstm_scan(params_fwd, xs, lengths, reverse=False)
    out_b, _ = lstm_scan(params_bwd, xs, lengths, reverse=True)
    return torch.cat([out_f, out_b], dim=-1)


def bilstm_stack(layers, xs, lengths):
    """Stacked bidirectional LSTM (``ops/rnn.py:169-179``); ``layers`` is a
    sequence of (params_fwd, params_bwd)."""
    for params_fwd, params_bwd in layers:
        xs = bilstm(params_fwd, params_bwd, xs, lengths)
    return xs
