"""Tacotron2 with location-sensitive attention (``models/tacotron2.py``,
``ops/attn_decode_cuda.py``) at tiny widths on the CPU, against the plain
reference the benchmark holds it to (``benchmark/reference/
tacotron2.py``), with the weights ``benchmark/weights.py`` seeds: the
mel, the stop logits and the attention weights, the first and the
cumulative weights, the stop rule, pinned lengths, rows that do not see
each other, and the output check's planted faults.  Tests marked ``cuda``
compare the kernel with its plain version on the card and skip here.
This file imports no JAX."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import tacotron2 as ref
from benchmark.reference.precision import Precision
from fcl_taco2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from fcl_taco2_tpu_torch.ops import attn_decode_cuda as K
from fcl_taco2_tpu_torch.ops.attn_decode_cuda import initial_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "tacotron2-synth-b16"
# fp32 throughout: the two sides differ only in the order of their fp32
# sums (a few ulp a step), carried by the loop's feedback over ~30 steps
TOL = 1e-5
TINY = dict(embed_dim=16, eunits=16, econv_chans=16, dunits=32,
            prenet_units=16, postnet_chans=16, adim=24, aconv_chans=4,
            aconv_filts=3, odim=8)


def config(**kw):
    """The cell's model group at tiny widths, every part in fp32."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "tacotron2-ljspeech.json")) as f:
        mc = json.load(f)["model"]
    mc.update(TINY, compute_dtype="float32")
    mc.update(kw)
    return mc


def model(mc, seed=7):
    m = Tacotron2(Tacotron2Config(**mc), device="cpu")
    sd = weights.seeded_state(m, seed, "cpu")
    m.load_state_dict(sd)
    return m, sd


def batch(B=3, T=9, ilens=(9, 6, 4), seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(1, 69, (B, T), generator=g)
    il = torch.tensor(ilens)
    tok[torch.arange(T)[None, :] >= il[:, None]] = 0
    return tok, il


SEED = 2 ** 31 - 77


def test_cpu_path_matches_the_reference():
    """Pinned lengths and free-running stops, dropout 0.5 on: every
    frame, stop logit and attention weight within TOL; padded positions
    and frames past a row's end exactly zero."""
    mc = config()
    m, sd = model(mc)
    tok, il = batch()
    seed = torch.tensor([SEED], dtype=torch.int32)
    for lengths in (torch.tensor([12, 30, 7]), None):
        out = m.synthesize(tok, il, seed, frame_budget=32, lengths=lengths,
                           with_att=True)
        want = ref.synthesize(sd, mc, tok, il, SEED, Precision("stated"),
                              torch.float32, 32, lengths=lengths)
        for b, (mel, stop, att) in enumerate(want):
            L, n = int(out["olens"][b]), int(il[b])
            assert L == mel.shape[0]
            assert (out["mel"][b, :L] - mel).abs().max() < TOL
            assert (out["stop"][b, :L] - stop).abs().max() < TOL
            assert (out["att"][b, :L, :n] - att).abs().max() < TOL
            assert (out["att"][b, :, n:] == 0).all()
            assert (out["mel"][b, L:] == 0).all()
            assert (out["stop"][b, L:] == 0).all()
        assert int(out["steps"]) == int(out["olens"].max())


def test_first_weights_and_the_cumulative_sum():
    """The first step's weights are 1/ilen over a row's own positions and
    zero on padding; each step's weights sum to 1 with nothing on padding;
    the port differs from a reference that keeps only the last step's
    weights, or that drops the location term, by far more than TOL."""
    w = initial_weights(torch.tensor([4, 1, 3]), 5)
    assert torch.equal(w, torch.tensor([[.25, .25, .25, .25, 0],
                                        [1, 0, 0, 0, 0],
                                        [1 / 3, 1 / 3, 1 / 3, 0, 0]]))
    mc = config(dropout_rate=0.0)
    m, sd = model(mc)
    tok, il = batch()
    lengths = torch.tensor([20, 20, 20])
    out = m.synthesize(tok, il, 0, frame_budget=20, lengths=lengths,
                       with_att=True)
    att = out["att"]
    assert torch.allclose(att.sum(-1), torch.ones(3, 20), atol=1e-6)
    for fault in ("no_cumulate", "no_location"):
        bad = ref.synthesize(sd, mc, tok, il, 0, Precision("stated"),
                             torch.float32, 20, lengths=lengths, fault=fault)
        gap = max((att[b, :, :int(il[b])] - a).abs().max().item()
                  for b, (_, _, a) in enumerate(bad))
        assert gap > 100 * TOL, fault


def _stop_model(bias, **kw):
    """A model whose stop logit is ``bias`` at every step."""
    mc = config(**kw)
    m, _ = model(mc)
    with torch.no_grad():
        m.decoder.prob_out.weight.zero_()
        m.decoder.prob_out.bias.fill_(bias)
    return m


def test_stop_token_ends_each_row_within_its_bounds():
    """A stop logit always above the threshold ends a row as soon as
    ``minlen`` allows; one always below runs it to ``maxlen``; the
    budget caps both.  With seeded weights each row ends at its own
    first stop at or after ``minlen`` (the logits it returned)."""
    tok, il = batch()
    for bias, lo_r, hi_r, budget, want in (
            (3.0, 1.0, 3.0, 64, il),
            (3.0, 0.0, 3.0, 64, torch.ones(3, dtype=torch.int64)),
            (-3.0, 1.0, 3.0, 64, 3 * il),
            (-3.0, 0.0, 10.0, 40, torch.tensor([40, 40, 40]))):
        m = _stop_model(bias, minlenratio=lo_r, maxlenratio=hi_r)
        out = m.synthesize(tok, il, 1, frame_budget=budget)
        assert torch.equal(out["olens"], want.to(torch.int64)), bias
    mc = config(minlenratio=0.5, maxlenratio=4.0)
    m, _ = model(mc, seed=3)
    with torch.no_grad():
        m.decoder.prob_out.bias.fill_(-0.3)
    out = m.synthesize(tok, il, 5, frame_budget=40)
    for b in range(3):
        lo, hi = int(int(il[b]) * 0.5), int(il[b]) * 4
        s = out["stop"][b]
        ends = [t + 1 for t in range(40)
                if t + 1 >= hi or (t + 1 >= lo and s[t] >= 0)]
        assert int(out["olens"][b]) == min(ends + [40])


def test_pinned_lengths_hold():
    m, _ = model(config())
    tok, il = batch()
    lengths = torch.tensor([5, 17, 1])
    out = m.synthesize(tok, il, 9, frame_budget=24, lengths=lengths)
    assert torch.equal(out["olens"], lengths)
    assert int(out["steps"]) == 17
    for b in range(3):
        L = int(lengths[b])
        assert (out["mel"][b, L:] == 0).all()
        assert (out["mel"][b, :L].abs().sum(-1) > 0).all()


def test_a_row_does_not_see_the_other_rows():
    """Row 1 of a ragged batch equals itself beside other utterances of
    other lengths (the dropout is keyed on the row's index) and, at
    dropout 0, run alone at the same padded width."""
    for rate in (0.5, 0.0):
        m, _ = model(config(dropout_rate=rate))
        tok, il = batch()
        other, il2 = batch(ilens=(3, 6, 9), seed=5)
        other[1] = tok[1]
        il2[1] = il[1]
        lengths = torch.tensor([4, 11, 2])
        a = m.synthesize(tok, il, 4, frame_budget=16, lengths=lengths)
        b = m.synthesize(other, il2, 4, frame_budget=16,
                         lengths=torch.tensor([16, 11, 9]))
        assert torch.allclose(a["mel"][1], b["mel"][1], atol=1e-6)
        assert torch.allclose(a["stop"][1], b["stop"][1], atol=1e-6)
        if rate == 0.0:
            # alone, padded to the same width (the encoder's convolutions
            # see the padding, as espnet's do)
            alone = m.synthesize(tok[1:2], il[1:2], 4, frame_budget=16,
                                 lengths=lengths[1:2])
            assert torch.allclose(a["mel"][1], alone["mel"][0], atol=1e-6)


def test_synthesizer_serves_it_through_the_models_plan():
    """``Synthesizer`` on the CPU: pinned lengths give the rows the
    model's own call gives, the budget is the frame bucket over the
    longest row (pinned, else ``maxlenratio`` times the phonemes), the
    stats carry the stop logits, and what Tacotron2 does not take is
    refused."""
    from fcl_taco2_tpu_torch.infer.synth import Synthesizer
    m, _ = model(config())
    s = Synthesizer(m, batch_size=4, tok_bucket=8, frame_bucket=16,
                    device="cpu")
    tok, il = batch(T=8, ilens=(8, 6, 4))
    toks = [tok[b, :int(il[b])].numpy() for b in range(3)]
    lengths = [7, 12, 3]
    mels, st = s.synth_batch(toks, 11, lengths=lengths)
    assert st["budget"] == 16 and st["redispatched"] == 0
    gen = torch.Generator().manual_seed(11)
    own = m.synthesize(tok, il, gen, frame_budget=16,
                       lengths=torch.tensor(lengths))
    for b, L in enumerate(lengths):
        assert mels[b].shape == (L, 8)
        np.testing.assert_allclose(mels[b], own["mel"][b, :L].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(st["stop"][b], own["stop"][b, :L].numpy(),
                                   atol=1e-6)
    _, free = s.synth_batch(toks[2:], 3)
    assert free["budget"] == 48  # 4 phonemes x maxlenratio 10, bucketed
    with pytest.raises(ValueError, match="speaking rate"):
        s.synth_batch(toks, 0, lengths=lengths, d_factor=1.2)
    with pytest.raises(ValueError, match="not both"):
        s.synth_batch(toks, 0, lengths=lengths, durations=toks)
    with pytest.raises(ValueError, match="unquantized"):
        Synthesizer(m, quantize="int8", device="cpu")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_check_fails_each_planted_fault(one_thread):
    """The cell's output check at tiny widths on the CPU: the program's
    own answers read inside every limit, and each planted fault (the
    location term dropped, the weights not accumulated, one utterance's
    frames reversed) reads above one of them at least."""
    from benchmark.tests import tiny
    spec = harness.load_spec(ROOT)
    _, config_, mix, driver, limits = harness.resolve(spec, CELL)
    mix = {**mix, **tiny.mix(batch=3, tok_bucket=8, frame_bucket=16)}
    mix["corpus"] = dict(mix["corpus"], dur_mean=2, dur_max=4)
    cfg = {**config_, "model": config(),
           "precision": dict(config_["precision"], compute_dtype="float32",
                             decoder_loop="float32")}
    drv = driver.Driver(cfg, mix, 2 ** 32 + 5, "cpu")
    drv.build()
    run = harness.Run(cfg, mix)
    drv.window(run, 0.2)
    assert run.failed == 0 and run.attempted > 0

    def ok(nums):
        return all(nums[k] <= v for k, v in limits.items() if k in nums)

    nums = drv.check()
    assert ok(nums) and nums["stop_max_err"] < TOL, nums
    faults = drv.fault_answers()
    assert set(faults) == {"reversed", "no_location", "no_cumulate"}
    for name, answers in faults.items():
        assert not ok(drv.check(answers)), name


def test_counts_of_a_step_add_up():
    """counts/tacotron2.py at the cell's widths: a batch-16 step of 71
    phonemes is ~0.57 GFLOP, and the loop's least bytes hold its bf16
    weights (~33 MB) once."""
    from benchmark.counts import tacotron2 as counts
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "tacotron2-ljspeech.json")) as f:
        mc = json.load(f)["model"]
    assert 0.55e9 < 16 * counts.decoder_step_flops(mc, 71) < 0.59e9
    nbytes = counts.decoder_loop_bytes(mc, [], 2)
    assert 32e6 < nbytes < 34e6


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the attention decode "
                    "kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_against_plain(dev, mc, B, T, budget, lengths, seed=0):
    """The kernel and its plain version (on the CPU) on one model's bf16
    weights and one frontend output: (kernel, plain) result dicts."""
    mc = dict(mc, compute_dtype="bfloat16")
    cfg = Tacotron2Config(**mc)
    m = Tacotron2(cfg, device=dev, seed=seed).compute_model()
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(1, cfg.idim, (B, T), generator=g)
    il = torch.randint(max(T // 3, 1), T + 1, (B,), generator=g)
    il[0] = T
    tok[torch.arange(T)[None, :] >= il[:, None]] = 0
    from fcl_taco2_tpu_torch.models.attention import project_memory
    from fcl_taco2_tpu_torch.models.encoder import encoder_apply
    with torch.no_grad():
        hs = encoder_apply(m.encoder, cfg, tok.to(dev), il.to(dev))
        pe = project_memory(m.decoder.att, hs)
        lo, hi = K.length_bounds(il.to(dev), budget, lengths.to(dev))
        kw = dict(budget=budget, zoneout=cfg.zoneout_rate,
                  dropout=cfg.dropout_rate, thr_logit=0.0)
        w = K.decoder_weights(m.decoder)
        n0 = K.attn_decode.launches
        got = K.attn_decode(w, hs, pe, il.to(dev), lo, hi,
                            torch.tensor([seed], dtype=torch.int32,
                                         device=dev), with_att=True, **kw)
        torch.cuda.synchronize()
        assert K.attn_decode.launches == n0 + 1
        cpu = {k: v.cpu() for k, v in w.items() if torch.is_tensor(v)}
        cpu["att"] = m.decoder.att.cpu()
        want = K.attn_decode_plain(cpu, hs.cpu(), pe.cpu(), il, lo.cpu(),
                                   hi.cpu(), seed, **kw)
    return got, want, il


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["tiny", "published"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_kernel_matches_plain_version(cuda, widths, dropout):
    """bf16 weights: frames, stop logits and weights within a bf16
    rounding carried by the feedback, at dropout 0 and with the shared
    Philox keying at 0.5; lengths, steps and zeros past each row's end
    exact."""
    mc = config(compute_dtype="bfloat16", dropout_rate=dropout)
    if widths == "published":
        mc.update({k: v for k, v in json.load(open(os.path.join(
            ROOT, "benchmark", "configs", "tacotron2-ljspeech.json")))[
                "model"].items() if k in TINY})
        B, T, budget = 16, 112, 48
    else:
        B, T, budget = 5, 20, 24
    lengths = torch.randint(1, budget + 1, (B,),
                            generator=torch.Generator().manual_seed(1))
    got, want, il = _kernel_against_plain(cuda, mc, B, T, budget, lengths)
    assert torch.equal(got["olens"].cpu(), want["olens"])
    assert int(got["steps"]) == int(want["steps"]) == int(lengths.max())
    for k, tol in (("out", 2e-2), ("stop", 2e-2), ("att", 2e-2)):
        g, w_ = got[k].cpu(), want[k]
        scale = w_.abs().max().item() + 1e-6
        assert (g - w_).abs().max().item() / scale < tol, (k, widths)
    past = torch.arange(budget)[None, :] >= got["olens"].cpu()[:, None]
    assert (got["out"].cpu()[past] == 0).all()


@pytest.mark.cuda
def test_synthesizer_graphs_the_kernel_and_counts_steps(cuda):
    """One Tacotron2 call through ``Synthesizer`` on the card: one graph,
    one kernel launch a replay, and the graph's ``ar.steps`` and
    ``ar.frames`` counters in ``spans.totals()``."""
    from fcl_taco2_tpu_torch.infer.synth import Synthesizer
    from fcl_taco2_tpu_torch.utils import spans
    mc = config(compute_dtype="bfloat16")
    m = Tacotron2(Tacotron2Config(**mc), device=cuda)
    s = Synthesizer(m, batch_size=4, tok_bucket=8, frame_bucket=16,
                    device=cuda)
    toks = [np.arange(1, 6), np.arange(2, 9), np.arange(3, 6)]
    n0 = K.attn_decode.launches
    for _ in range(3):
        mels, st = s.synth_batch(toks, 11, lengths=[7, 12, 3])
    assert [x.shape[0] for x in mels] == [7, 12, 3]
    assert K.attn_decode.launches >= n0 + 3
    g = spans.totals()["synthesize"]
    assert g["counters"]["ar.frames"] * 12 == g["counters"]["ar.steps"] * 22
    assert {"serve.frontend", "serve.decoder", "serve.postnet"} \
        <= set(g["spans"])
    assert math.isfinite(float(st["stop"][0][0]))
