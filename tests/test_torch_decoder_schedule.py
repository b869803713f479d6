"""The AR-decoder kernel's operand layout and schedule, replayed in PyTorch
on the CPU (no JAX, no card).

``csrc/ar_decode.cu`` cannot run here, so this file replays what it does
with the operands it is given: the packed weights of
``pack_decoder_weights`` (B-fragment order, gate columns grouped by the
units a block owns), the fragment-ordered activations written in the type
they are multiplied in, the products as the kernel's lanes form them
(``frag_mm``), each block's unit slice with its cluster pair's K halves,
16-row tiles, the fused [feat_out(t-1) + prenet(t)] phase with its step
offset and ragged bounds that stop tiles mid-loop.  The replay is held
to ``_ar_loop_plain`` (the plain version every card run compares the
kernel with), and deliberately broken indexing must fail it.
``test_tf32_products_at_student_widths`` emulates the kernel's 3xTF32
products (csrc/tf32.cuh) at the student's widths against the fp32 plain
loop.

Tolerances: 2e-5 in fp32 (tests/test_torch_port_decoder.py: sums in
another order, through the AR steps); ``0.05 * scale + 1e-3`` for bf16 and
int8 weights, whose rounding the AR feedback compounds (the same file);
1e-4 for 3xTF32 (the card's fp32 limit).
"""

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.ops import decoder_cuda as K

ATOL_F32 = 2e-5
TOL_TF32 = 1e-4
IDIM, U, O, H, D = 11, 12, 8, 40, 9


def r16(x):
    return -(-x // 16) * 16


def dec_params(idim=IDIM, units=U, odim=O, hidden=H, seed=0):
    """Random decoder weights in the JAX layout (numpy, seeded)."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    G = 4 * hidden
    return {
        "prenet": {"layers": [{"w": w(odim, units), "b": w(units)},
                              {"w": w(units, units), "b": w(units)}]},
        "lstm0": {"wx": w(idim + units + 1, G), "wh": w(hidden, G),
                  "bx": w(G), "bh": w(G)},
        "lstm1": {"wx": w(hidden, G), "wh": w(hidden, G), "bx": w(G),
                  "bh": w(G)},
        "feat_out": {"w": w(hidden + idim, odim)},
    }


def inputs(P, ragged, idim=IDIM, steps=D, seed=0):
    rng = np.random.default_rng(seed + 1)
    dur = rng.integers(0, steps + 1, P)
    if ragged:  # synthesize sorts segments by duration, descending
        dur = np.sort(dur)[::-1].copy()
    dur = torch.from_numpy(dur.astype(np.int32))
    d = torch.arange(steps)[None]
    pos = torch.where(d < dur[:, None], d / dur[:, None].clamp(min=1), 0.0)
    enc = torch.from_numpy(rng.standard_normal((P, idim)).astype(np.float32))
    fm = (d < dur[:, None]).float()[..., None]
    return enc, pos.float(), fm, K.tile_step_bounds(dur) if ragged else None


# ---------------------------------------------------------------------------
# the kernel's products and layouts
# ---------------------------------------------------------------------------

def tf32_split(x):
    """csrc/tf32.cuh::split: hi = x with the low 13 bits cleared, lo the
    remainder truncated likewise."""
    mask = torch.tensor(-8192, dtype=torch.int32)  # 0xffffe000
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def frag_mm(A, Bp, mode):
    """What the kernel's lanes compute: A (R, Kp) fragment-ordered
    activations times Bp (NT, Kp/16, 32, 4) packed weights, lane 4 gid + t
    multiplying its four values of each k16 step: out[r, 8 nt + gid] =
    sum A[r, 16 kg + 4 t + e] * Bp[nt, kg, 4 gid + t, e].  ``mode``:
    "fp32" exact products, "3xtf32" the kernel's fp32 scheme, "tf32" one
    TF32 pass (for comparison)."""
    R, NT, KG = A.shape[0], Bp.shape[0], Bp.shape[1]
    a = A.float().reshape(R, KG, 4, 4)
    b = Bp.float().reshape(NT, KG, 8, 4, 4)

    def mm(x, y):
        return torch.einsum("rkte,nkgte->rng", x, y)

    if mode == "fp32":
        out = mm(a, b)
    else:
        ah, al = tf32_split(a)
        bh, bl = tf32_split(b)
        out = mm(ah, bh) if mode == "tf32" else \
            mm(al, bh) + mm(ah, bl) + mm(ah, bh)
    return out.reshape(R, NT * 8)


def replay(pk, enc, pos, bounds, *, zoneout=0.1, resident=True,
           mode="fp32", fault=None):
    """The kernel's schedule at dropout 0 (the dropout draws are checked on
    the card by their statistics).  ``fault`` injects one indexing error:
    "slice" (a block's gates taken for the next block's units), "half"
    (a cluster's second block multiplying the first K half), "step" (the
    fused phase writing frame t-1 at step t), "apos" (activations written
    in the other type's fragment order)."""
    adt = K._act_dtype(pk.wdt)
    Hh, Uu, Oo, I = pk.H, pk.units, pk.odim, pk.idim
    Hp, Up, Op, Ip = r16(Hh), r16(Uu), r16(Oo), r16(I)
    G, ub = 4 * Hh, pk.ub
    nt8, n_slices = ub // 2, Hp // ub
    P, Dd = pos.shape
    f32 = torch.float32
    if fault == "apos":
        adt_pos = torch.float32 if adt == torch.bfloat16 else torch.bfloat16
    else:
        adt_pos = adt

    def act(x, Kp):
        """Logical (R, K) -> fragment-ordered (R, Kp), rounded to adt."""
        out = torch.zeros(x.shape[0], Kp)
        out[:, K.act_positions(Kp, adt_pos)[:x.shape[1]]] = x.to(adt).to(f32)
        return out

    n16 = -(-P // 16)

    def bound(rt):
        return min(int(bounds[rt * 16 // K.TILE]), Dd) if bounds is not None \
            else Dd

    T = max(bound(rt) for rt in range(n16))
    if resident:
        ea = act(enc, Ip)
        eg = frag_mm(ea, pk.wx0ek, mode)[:, :G] + pk.bx0
        eo = frag_mm(ea, pk.wfek, mode)[:, :Oo]
    else:
        eg = enc @ pk.wx0_enc.float() + pk.bx0
        eo = enc @ pk.wf_enc.float()
    scales = pk.scales if pk.scales is not None else torch.ones(3, G)
    out = torch.zeros(P, Dd, Oo)
    hx0, hx1 = torch.zeros(P, Hp), torch.zeros(P, Hp)  # fragment order
    h0 = c0 = h1 = c1 = torch.zeros(P, Hh)             # fp32 state
    p2 = torch.zeros(P, Up)
    keep = 1.0 - zoneout
    for t in range(T + 1):
        # [feat_out(t-1) + prenet(t)], one 16-row tile at a time
        for rt in range(n16):
            rows = slice(16 * rt, min(16 * rt + 16, P))
            b = bound(rt)
            feat, pre = t > 0 and t - 1 < b, t < T and t < b
            frame = torch.zeros(rows.stop - rows.start, Op)
            if feat:
                v = frag_mm(hx1[rows], pk.wfk, mode)[:, :Oo] + eo[rows]
                if fault != "step":
                    out[rows, t - 1] = v
                elif t < Dd:
                    out[rows, t] = v
                frame = act(v, Op)
            if pre:
                p1 = frag_mm(frame, pk.w1k, mode)[:, :Uu] if t > 0 else \
                    torch.zeros(frame.shape[0], Uu)  # prev = 0 at t = 0
                p1 = act(torch.relu(p1 + pk.pre_b1), Up)
                v = frag_mm(p1, pk.w2k, mode)[:, :Uu] + pk.pre_b2
                p2[rows] = act(torch.relu(v), Up)
        if t == T:
            break
        live = torch.tensor([t < bound(r // 16) for r in range(P)])
        for layer in (0, 1):
            ax_in, ah_in = (p2, hx0) if layer == 0 else (hx0, hx1)
            wx, wh = (pk.wx0k, pk.wh0k) if layer == 0 else (pk.wx1k, pk.wh1k)
            gates = torch.zeros(P, Hp, 4)
            sx = torch.ones_like(scales[0]) if layer == 0 else scales[1]
            sh = scales[0] if layer == 0 else scales[2]
            for s in range(n_slices):
                tiles = slice(s * nt8, (s + 1) * nt8)
                # slice s: unit-major columns, u = n // 4, gate = n % 4;
                # the block pair (s // 2) splits each K range in halves,
                # each half's scaled sums added half 0 + half 1
                prod = 0.0
                for r in (0, 1):
                    parts = []
                    for a_in, w in ((ax_in, wx), (ah_in, wh)):
                        kg = w.shape[1]
                        k0 = kg // 2 if r else 0
                        k1 = kg if r else kg // 2
                        if fault == "half" and r:
                            k0, k1 = 0, kg - kg // 2
                        parts.append(frag_mm(
                            a_in[:, 16 * k0:16 * k1],
                            w[tiles, k0:k1], mode).view(P, ub, 4))
                    prod = prod + (
                        parts[0] * _gate_scale(sx, Hh, Hp, s, ub)
                        + parts[1] * _gate_scale(sh, Hh, Hp, s, ub))
                dst = ((s + 1) % n_slices if fault == "slice" else s) * ub
                if layer == 0:
                    gates[:, dst:dst + ub] = (
                        _gate_cols(eg, Hh, Hp, s, ub) + prod
                        + pos[:, t, None, None]
                        * _gate_cols(pk.wx0_pos[None], Hh, Hp, s, ub)
                        + _gate_cols(pk.bh0[None], Hh, Hp, s, ub))
                else:
                    gates[:, dst:dst + ub] = (
                        _gate_cols((pk.bx1 + pk.bh1)[None], Hh, Hp, s, ub)
                        + prod)
            gi, gf, gg, go = gates[:, :Hh].unbind(-1)
            h, c = (h0, c0) if layer == 0 else (h1, c1)
            c_n = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h_n = torch.sigmoid(go) * torch.tanh(c_n)
            h_new = torch.where(live[:, None], zoneout * h + keep * h_n, h)
            c_new = torch.where(live[:, None], zoneout * c + keep * c_n, c)
            hx_new = torch.where(live[:, None], act(h_new, Hp),
                                 hx0 if layer == 0 else hx1)
            if layer == 0:
                h0, c0, hx0 = h_new, c_new, hx_new
            else:
                h1, c1, hx1 = h_new, c_new, hx_new
    return out


def _gate_cols(v, Hh, Hp, s, ub):
    """Rows of a (R, 4H) gate-indexed tensor at slice s's units, as
    (R, ub, 4) with padded units zero."""
    full = torch.zeros(v.shape[0], Hp, 4)
    full[:, :Hh] = v.reshape(v.shape[0], 4, Hh).transpose(1, 2)
    return full[:, s * ub:(s + 1) * ub]


def _gate_scale(scale, Hh, Hp, s, ub):
    return _gate_cols(scale[None], Hh, Hp, s, ub)


def unpack_b(packed, Kk, Nn, act_dtype):
    """Inverse of ``decoder_cuda.pack_b``: the (K, N) matrix (in the
    packed dtype)."""
    NT, KG = packed.shape[:2]
    kidx = K._KIDX[act_dtype].to(packed.device)
    v = packed.view(NT, KG, 8, 4, 4).permute(1, 3, 4, 0, 2)
    full = torch.zeros(KG, 16, NT, 8, dtype=packed.dtype,
                       device=packed.device)
    full[:, kidx] = v
    return full.reshape(KG * 16, NT * 8)[:Kk, :Nn]


def ungate_order(w, H):
    """Inverse of ``decoder_cuda.gate_order``: (K, 4 Hp) -> (K, 4H)."""
    Kk = w.shape[0]
    return w.view(Kk, -1, 4)[:, :H].transpose(1, 2).reshape(Kk, 4 * H)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ub", [2, 8])
def test_pack_unpacks_to_the_jax_layout(wdt, ub):
    dp = dec_params()
    pk = K.pack_decoder_weights(dp, IDIM, wdt, ub=ub)
    w = K._split(dp, IDIM)
    adt = K._act_dtype(pk.wdt)
    rdt = torch.bfloat16 if wdt == torch.int8 else wdt
    Hp, Up, Op, Ip = r16(H), r16(U), r16(O), r16(IDIM)

    def plain(packed, Kk, Nn):
        return unpack_b(packed, Kk, Nn, adt)

    def gates(packed, Kk):
        return ungate_order(plain(packed, Kk, 4 * Hp), H)

    assert torch.equal(plain(pk.w1k, O, U), w["pre_w1"].to(rdt))
    assert torch.equal(plain(pk.w2k, U, U), w["pre_w2"].to(rdt))
    assert torch.equal(plain(pk.wfk, H, O), w["wf_z"].to(rdt))
    assert torch.equal(plain(pk.wx0ek, IDIM, 4 * H), w["wx0_enc"].to(rdt))
    assert torch.equal(plain(pk.wfek, IDIM, O), w["wf_enc"].to(rdt))
    assert torch.equal(gates(pk.wx0k, U), w["wx0_pre"].to(rdt))
    assert torch.equal(pk.wx0_pos, w["wx0_pos"].to(rdt).float())
    if wdt == torch.int8:
        codes, scales = K.prequantize_hbm_weights(dp)
        big = torch.cat([gates(m, H) for m in (pk.wh0k, pk.wx1k,
                                               pk.wh1k)])
        assert big.dtype == torch.int8 and torch.equal(big, codes)
        assert torch.equal(pk.scales, scales)
    else:
        for m, name in ((pk.wh0k, "wh0"), (pk.wx1k, "wx1"),
                        (pk.wh1k, "wh1")):
            assert torch.equal(gates(m, H), w[name].to(wdt))
    # padding is zero, so padded K rows and units contribute nothing
    full = unpack_b(pk.wh0k, Hp, 4 * Hp, adt)
    assert not full[H:].any()
    assert not full.view(Hp, Hp, 4)[:, H:].any()
    assert unpack_b(pk.w1k, Op, Up, adt)[O:].abs().sum() == 0
    assert pk.wx0ek.shape == (r16(4 * H) // 8, Ip // 16, 32, 4)


@pytest.mark.parametrize("adt", [torch.float32, torch.bfloat16])
def test_activation_positions_match_the_fragments(adt):
    pos = K.act_positions(32, adt)
    assert sorted(pos.tolist()) == list(range(32))
    # lane t's four values of a k16 step sit at 4t..4t+3 in KIDX order
    for t in range(4):
        for e in range(4):
            k = int(K._KIDX[adt][t, e])
            assert pos[k] == 4 * t + e and pos[16 + k] == 16 + 4 * t + e


CASES = [(wdt, P, ragged) for wdt in (torch.float32, torch.bfloat16,
                                      torch.int8)
         for P in (16, 96, 200) for ragged in (False, True)]


@pytest.mark.parametrize("wdt,P,ragged", CASES)
def test_replay_matches_the_plain_loop(wdt, P, ragged):
    dp = dec_params()
    enc, pos, fm, bounds = inputs(P, ragged)
    if ragged and P == 200:  # two bound groups: the second stops early
        assert int(bounds[1]) < int(bounds[0])
    resident = wdt == torch.float32
    plain = K.fused_ar_decode_plain if resident else \
        K.fused_ar_decode_hbm_plain
    want = plain(dp, enc, pos, 0, zoneout=0.1, dropout=0.0,
                 weights_dtype=wdt, bounds=bounds)
    for ub in (2, 8):
        pk = K.pack_decoder_weights(dp, IDIM, wdt, ub=ub)
        got = replay(pk, enc, pos, bounds, resident=resident)
        err = float(((got - want) * fm).abs().max())
        if wdt == torch.float32:
            assert err < ATOL_F32, (ub, err)
        else:
            scale = float(want.abs().max())
            assert err < 0.05 * scale + 1e-3, (ub, err, scale)
        if ragged:  # frames at or past a row's tile bound are zero
            rows = K._row_bounds(bounds, P, D, "cpu")
            past = torch.arange(D)[None] >= rows[:, None]
            assert (got[past] == 0).all()


@pytest.mark.parametrize("fault", ["slice", "half", "step", "apos"])
def test_broken_indexing_fails_the_replay(fault):
    dp = dec_params()
    enc, pos, fm, bounds = inputs(96, True)
    wdt = torch.bfloat16 if fault == "apos" else torch.float32
    plain = K.fused_ar_decode_plain
    want = plain(dp, enc, pos, 0, zoneout=0.1, dropout=0.0,
                 weights_dtype=wdt, bounds=bounds)
    pk = K.pack_decoder_weights(dp, IDIM, wdt, ub=2)
    got = replay(pk, enc, pos, bounds, fault=fault)
    err = float(((got - want) * fm).abs().max())
    assert err > 0.05 * float(want.abs().max()) + 1e-3, err


def test_tf32_products_at_student_widths(capsys):
    """3xTF32 with the kernel's truncating split stays within 1e-4 of the
    fp32 plain loop at H = 256, prenet 256, odim 80, 50 steps; one TF32
    pass is printed beside it."""
    idim, steps = 64, 50
    dp = dec_params(idim=idim, units=256, odim=80, hidden=256, seed=3)
    with torch.no_grad():  # the published init's scale: ~1/sqrt(fan_in)
        for m in (dp["lstm0"]["wx"], dp["lstm0"]["wh"], dp["lstm1"]["wx"],
                  dp["lstm1"]["wh"], dp["feat_out"]["w"]):
            m.mul_(1.0 / (0.3 * m.shape[0] ** 0.5))
    rng = np.random.default_rng(5)
    P = 16
    dur = torch.full((P,), steps, dtype=torch.int32)
    d = torch.arange(steps)[None]
    pos = (d / dur[:, None]).float().expand(P, steps).contiguous()
    enc = torch.from_numpy(rng.standard_normal((P, idim)).astype(np.float32))
    want = K.fused_ar_decode_plain(dp, enc, pos, 0, zoneout=0.1,
                                   dropout=0.0)
    pk = K.pack_decoder_weights(dp, idim, torch.float32, ub=2)
    err3 = float((replay(pk, enc, pos, None, mode="3xtf32")
                  - want).abs().max())
    err1 = float((replay(pk, enc, pos, None, mode="tf32") - want).abs().max())
    with capsys.disabled():
        print(f"\n[tf32] student widths, 50 steps, output scale "
              f"{float(want.abs().max()):.3f}: 3xTF32 {err3:.3e}, one TF32 "
              f"pass {err1:.3e} (limit {TOL_TF32:g})")
    assert err3 < TOL_TF32, err3
