"""The serving BiLSTM's route, its design and argument checks on the CPU
(``ops/blstm_cuda.py``; the kernel, ``csrc/blstm.cu``, runs only on the
card: ``tests/test_torch_port_blstm_cuda.py``).

- ``encoder_apply`` takes the kernel only when serving (not training,
  autograd off, tokens on the card); training and grad mode keep
  ``bilstm_stack``, and serving on the CPU is the loop bit for bit.
- The kernel's slices, zero-padded: a replay of its schedule in float64
  from the cells' own W_hh and b_hh (slices of ``UB`` units, gate-major
  columns, the padded width, ragged lengths, the loop to the longest row)
  equals the unpadded loop, with every padded unit exactly zero; and the
  order in which ``load_slice`` writes a slice into shared memory,
  transcribed here, is ``ops/decoder_cuda.py::pack_b``'s fragment order
  (what ``warp_mma`` reads), every position written once, in order.
- The wrapper's checks raise on what the kernel does not take.
"""

import copy
import types

import pytest
import torch
import torch.nn as nn

from fcl_taco2_tpu_torch.models import encoder as E
from fcl_taco2_tpu_torch.models.config import ModelConfig
from fcl_taco2_tpu_torch.ops import blstm_cuda as K
from fcl_taco2_tpu_torch.ops import rnn
from fcl_taco2_tpu_torch.ops.decoder_cuda import pack_b


def _cells(H, d_in, dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    cells = [nn.LSTMCell(d_in, H, dtype=dtype) for _ in range(2)]
    with torch.no_grad():
        for c in cells:
            for p in c.parameters():
                p.uniform_(-0.8, 0.8)
    return cells


def _tiny_encoder(seed=0):
    cfg = ModelConfig(idim=12, embed_dim=8, eunits=12, econv_layers=1,
                      econv_chans=8, econv_filts=3)
    torch.manual_seed(seed)
    enc = E.Encoder(cfg, device="cpu").eval()
    tokens = torch.tensor([[3, 5, 7, 2, 9, 1], [4, 4, 6, 0, 0, 0],
                           [11, 0, 0, 0, 0, 0]])
    ilens = torch.tensor([6, 3, 1])
    return enc, cfg, tokens, ilens


@pytest.mark.parametrize("train,grad,cuda,want", [
    (False, False, True, True),
    (True, False, True, False),
    (False, True, True, False),
    (True, True, True, False),
    (False, False, False, False),
])
def test_serving_route_takes_the_kernel_only_when_serving(train, grad, cuda,
                                                          want):
    tokens = types.SimpleNamespace(is_cuda=cuda)
    with torch.set_grad_enabled(grad):
        assert E.serving_recurrence(train, tokens) is want


@pytest.mark.parametrize("serving", [True, False])
def test_encoder_apply_wires_the_route(monkeypatch, serving):
    enc, cfg, tokens, ilens = _tiny_encoder()
    calls = []

    def infer(fwd, bwd, x, lengths):
        calls.append(("infer", fwd, bwd))
        return rnn.bilstm(fwd, bwd, x, lengths)

    def stack(layers, x, lengths):
        calls.append(("stack",))
        return rnn.bilstm_stack(layers, x, lengths)

    monkeypatch.setattr(E, "serving_recurrence", lambda train, t: serving)
    monkeypatch.setattr(E, "bilstm_infer", infer)
    monkeypatch.setattr(E, "bilstm_stack", stack)
    with torch.no_grad():
        E.encoder_apply(enc, cfg, tokens, ilens)
    if not serving:
        assert calls == [("stack",)]
        return
    assert calls == [("infer", lay["fwd"], lay["bwd"])
                     for lay in enc.blstm]


@pytest.mark.parametrize("train,grad", [(True, False), (False, True),
                                        (False, False)])
def test_cpu_encoder_is_the_loop_bit_for_bit(train, grad):
    enc, cfg, tokens, ilens = _tiny_encoder(seed=1)
    with torch.set_grad_enabled(grad):
        got = E.encoder_apply(enc, cfg, tokens, ilens, train=False)
        x = enc.embed.weight[tokens]
        x = E.C.encoder_convs_apply(enc.convs, x, cfg.use_residual)
        lay = enc.blstm[0]
        want = rnn.bilstm_stack([(lay["fwd"], lay["bwd"])], x, ilens)
    assert torch.equal(got, want)


def _slices(cell, ub, cs):
    """(cs, Hu, 4 ub) W_hh^T slices and (cs, 4 ub) b_hh of one cell as the
    kernel builds them: slice r's column q ub + u is gate q of unit
    r ub + u; units and K rows past H are zero."""
    H = cell.weight_hh.shape[1]
    Hu = ub * cs
    w = cell.weight_hh.detach().new_zeros(4, Hu, Hu)
    w[:, :H, :H] = cell.weight_hh.detach().view(4, H, H)
    b = cell.bias_hh.detach().new_zeros(4, Hu)
    b[:, :H] = cell.bias_hh.detach().view(4, H)
    wt = w.view(4, cs, ub, Hu).permute(1, 3, 0, 2).reshape(cs, Hu, 4 * ub)
    return wt, b.view(4, cs, ub).permute(1, 0, 2).reshape(cs, 4 * ub)


def _replay(cells, xs, lengths):
    """The kernel's schedule in plain PyTorch: per direction, the loop to
    the longest row; each block's slice of units computes its gates from
    the whole padded h, and h is gathered from the slices before the next
    step.  Outputs (B, T, 2 Hu)."""
    H = cells[0].weight_hh.shape[1]
    ub, cs = K.geometry(H)
    Hu = ub * cs
    B, T, _ = xs.shape
    steps = int(lengths.max())
    out = xs.new_zeros(B, T, 2 * Hu)
    for d, cell in enumerate(cells):
        w, b = _slices(cell, ub, cs)
        xp = torch.nn.functional.linear(xs, cell.weight_ih, cell.bias_ih)
        xg = xs.new_zeros(B, T, 4, Hu)
        xg[..., :H] = xp.reshape(B, T, 4, H)
        h = xs.new_zeros(B, Hu)
        c = xs.new_zeros(B, Hu)
        for s in range(steps):
            t = steps - 1 - s if d else s
            hn, cn = [], []
            for r in range(cs):
                sl = slice(r * ub, (r + 1) * ub)
                g = (h @ w[r] + b[r]).view(B, 4, ub) + xg[:, t, :, sl]
                i, f, gg, o = g.unbind(1)
                cc = torch.sigmoid(f) * c[:, sl] + \
                    torch.sigmoid(i) * torch.tanh(gg)
                hn.append(torch.sigmoid(o) * torch.tanh(cc))
                cn.append(cc)
            v = (t < lengths)[:, None]
            h = torch.where(v, torch.cat(hn, 1), h)
            c = torch.where(v, torch.cat(cn, 1), c)
            out[:, t, d * Hu:(d + 1) * Hu] = torch.where(v, h, 0.0)
    return out


@pytest.mark.parametrize("lengths", [[7, 1, 4], [9]])
@pytest.mark.parametrize("H", [6, 20, 140])
def test_padded_slices_replay_the_loop(H, lengths):
    cells = [c.double() for c in _cells(H, 5, seed=H)]
    ub, cs = K.geometry(H)
    assert ub * cs >= H
    lengths = torch.tensor(lengths)
    g = torch.Generator().manual_seed(H)
    xs = torch.randn(len(lengths), 9, 5, generator=g, dtype=torch.float64)
    with torch.no_grad():
        got = _replay(cells, xs, lengths)
        want = rnn.bilstm(*cells, xs, lengths)
    Hu = ub * cs
    for d in range(2):
        assert not got[..., d * Hu + H:(d + 1) * Hu].any()  # padded units
    got = torch.cat([got[..., :H], got[..., Hu:Hu + H]], -1)
    # the slices hold the weights exactly: only the sums' order differs
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert not got[:, int(lengths.max()):].any()


def _apos(k, dtype):
    """``apos`` of csrc/mma_common.cuh: logical column k's position in the
    fragment-ordered layout."""
    r = k & 15
    if dtype == torch.bfloat16:
        q = r & 7
        return (k & ~15) + 4 * (q >> 1) + 2 * (r >> 3) + (q & 1)
    return (k & ~15) + 4 * (r & 3) + (r >> 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_load_order_is_the_mma_fragment_order(dtype):
    """csrc/blstm.cu::load_slice's job i takes column n = (i / 8) / KG 8 +
    i % 8 and k16 step kg = (i / 8) % KG, and stores its 16 values k, each
    at apos(k % 16), from ((n / 8) KG + kg) 128 + (n % 8) 16: that is
    ``pack_b``'s order of the (Kp, 4 UB) slice, which ``warp_mma`` reads,
    and the jobs' stores, in job order, fill the slice contiguously."""
    H = 140
    ub, cs = K.geometry(H)
    Kp, N = ub * cs, 4 * ub
    kg_n = Kp // 16
    slice_ = torch.arange(Kp * N, dtype=torch.float64).view(Kp, N)
    got = torch.full((Kp * N,), -1.0, dtype=torch.float64)
    for i in range(N * kg_n):
        n = (i >> 3) // kg_n * 8 + (i & 7)
        kg = (i >> 3) % kg_n
        start = ((n >> 3) * kg_n + kg) * 128 + (n & 7) * 16
        assert start == 16 * i
        for e in range(16):
            pos = start + _apos(e, dtype)
            assert got[pos] == -1.0
            got[pos] = slice_[16 * kg + e, n]
    want = pack_b(slice_, Kp, N, torch.float64, dtype).reshape(-1)
    assert torch.equal(got, want)


def _bad_cases():
    def case(mutate):
        cells = _cells(6, 5, seed=3)
        xs = torch.randn(2, 4, 5)
        lengths = torch.tensor([4, 2])
        return mutate(cells, xs, lengths)

    def half_cells(c, x, n):
        return [copy.deepcopy(k).half() for k in c], x.half(), n

    return {
        "float16 xs": (lambda: case(lambda c, x, n: (c, x.half(), n)),
                       "float32 or bfloat16"),
        "float16 weights": (lambda: case(half_cells), "float32 or bfloat16"),
        "2-D xs": (lambda: case(lambda c, x, n: (c, x[0], n)), "B, T, in"),
        "lengths of another batch": (lambda: case(
            lambda c, x, n: (c, x, n[:1])), "lengths must be"),
        "float lengths": (lambda: case(
            lambda c, x, n: (c, x, n.float())), "lengths must be"),
        "lengths on another device": (lambda: case(
            lambda c, x, n: (c, x, n.to("meta"))), "mixed devices"),
        "weights of another dtype": (lambda: case(
            lambda c, x, n: (c, x.bfloat16(), n)), "differ"),
        "CPU tensors": (lambda: case(lambda c, x, n: (c, x, n)),
                        "runs on the card"),
    }


@pytest.mark.parametrize("name", list(_bad_cases()))
def test_the_checks_raise(name):
    make, match = _bad_cases()[name]
    cells, xs, lengths = make()
    with pytest.raises(ValueError, match=match):
        K.check(*cells, xs, lengths)
    with pytest.raises(ValueError, match=match):
        K.bilstm_infer(*cells, xs, lengths)


@pytest.mark.parametrize("H", [0, 257])
def test_widths_past_the_kernel_raise(H):
    with pytest.raises(ValueError):
        K.geometry(H)
