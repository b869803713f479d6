"""The port's spans (``utils/spans.py``) on the CPU: the regions a capture
records and what the mark kernel (``csrc/spans.cu``) adds up from them,
the backward spans' place in the autograd order, the regroup gathers'
backward bit-equal to plain indexing, the scans unchanged by their spans,
``Graphed``'s replay timing, and nothing to read without a capture."""

import numpy as np
import pytest
import torch

from benchmark import harness
from fcl_taco2_tpu_torch.ops import regroup, rnn_vjp
from fcl_taco2_tpu_torch.utils import graphs, spans
from fcl_taco2_tpu_torch.utils.spans import OTHER, span

NEW_METRICS = ["acoustic_ms.tts", "vocoder_ms.tts", "launch_ms.tts",
               "span_idle_pct.tts", "frontend_ms.synth", "decoder_ms.synth",
               "postnet_ms.synth", "launch_ms.synth", "span_idle_pct.synth",
               "forward_ms.train", "scan_fwd_ms.train", "scan_bwd_ms.train",
               "regroup_bwd_ms.train", "backward_ms.train",
               "optim_ms.train", "launch_ms.train", "span_idle_pct.train"]


class FakeCard:
    """A capture's slots and launches on the host: each mark is recorded
    as (last slot, region slot)."""

    def __init__(self):
        self.used, self.launched = 0, []
        self.slots = torch.zeros(64, dtype=torch.int64)

    def alloc(self):
        self.used += 1
        return self.used - 1

    def launch(self, last, region):
        self.launched.append((last, region))


def replay_regions(seq, stamps):
    """What ``span_mark`` adds up over one replay of a capture whose marks
    end the regions ``seq`` (``Capture.seq``), read at ``stamps``:
    {region: ns}."""
    out, last = {}, None
    for ends, now in zip(seq, stamps):
        if ends is not None:
            out[ends] = out.get(ends, 0) + now - last
        last = now
    return out


@pytest.fixture
def capture(monkeypatch):
    """A ``spans.Capture`` made active as ``Graphed`` makes one, with the
    current stream reported as being captured."""
    card = FakeCard()
    cap = spans.Capture(card, card.launch)
    monkeypatch.setattr(spans, "_active", cap)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    cap.card = card
    return cap


def test_nested_spans_add_up_to_self_times(capture):
    capture.begin()
    with span("a"):
        with span("b"):
            pass
        with span("b"):
            pass
    with span("c"):
        pass
    capture.end()
    assert capture.seq == [None, OTHER, "a", "b", "a", "b", "a", OTHER, "c",
                           OTHER]
    assert capture.counts == {"a": 1, "b": 2, "c": 1}
    # every mark moves the graph's own stamp and ends the recorded region
    slot = {**capture.regions, None: -1}
    assert capture.card.launched == [(capture.last, slot[r])
                                     for r in capture.seq]
    stamps = [0, 5, 12, 20, 21, 30, 34, 40, 41, 50]
    got = replay_regions(capture.seq, stamps)
    assert got == {OTHER: 5 + 6 + 9, "a": 7 + 1 + 4, "b": 8 + 9, "c": 1}
    assert sum(got.values()) == stamps[-1] - stamps[0]
    # three replays' sums, as the slots would hold them
    values = [0] * capture.card.used
    for name, ns in got.items():
        values[capture.regions[name]] = 3 * ns
    assert capture.totals(values, 3)["b"] == {"ns": 51, "count": 6}


def test_a_span_is_a_range_of_the_profilers_trace():
    """Under a profiler a span (and a backward span) is a
    ``record_function`` range of the trace; without one nothing is
    recorded and nothing is captured."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            bs = spans.backward_span("inner.bwd")
            (y,) = bs.outputs((bs.inputs(x)[0] * 2).sin())
        y.sum().backward()
    names = {e.name for e in prof.events()}
    assert {"outer", "inner.bwd"} <= names
    with span("quiet") as s:
        assert s._range is None and s._cap is None


def test_an_open_span_at_the_end_of_a_capture_raises(capture):
    capture.begin()
    capture.enter("a")
    with pytest.raises(RuntimeError, match="left open"):
        capture.end()


def test_backward_spans_open_inside_the_backward(capture):
    """The stretch's backward runs between its two identities: its span
    nests inside the span around ``autograd.grad``, and gradients pass
    unchanged."""
    x = torch.randn(4, requires_grad=True)
    w = torch.randn(4, requires_grad=True)
    capture.begin()
    with span("fwd"):
        bs = spans.backward_span("bwd")
        xi, wi = bs.inputs(x, w)
        (y,) = bs.outputs((xi * wi).sin())
        z = (y * 3).cos().sum() + x.sum()
    with span("back"):
        gx, gw = torch.autograd.grad(z, (x, w))
    capture.end()
    assert capture.seq == [None, OTHER, "fwd", OTHER, "back", "bwd", "back",
                           OTHER]
    ex, ew = torch.autograd.grad(((x * w).sin() * 3).cos().sum() + x.sum(),
                                 (x, w))
    assert torch.equal(gx, ex) and torch.equal(gw, ew)
    # nothing to span without a gradient to take
    with torch.no_grad():
        assert spans.backward_span("b").inputs(x)[0] is x


def _plans(seed=0, B=5, T=9):
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 12, size=(B, T)).astype(np.int32)
    dur[:, -2:] = 0  # padded tokens
    olens = dur.sum(1)
    Lmax = int(olens.max()) + 3
    single = regroup.build_plan(dur, olens, 12, 64, Lmax)
    classed = regroup.build_classed_plan(dur, olens, (3, 8, 12),
                                         (24, 24, 16), Lmax)
    return single, classed


def _grad(fn, x, g):
    x = x.detach().clone().requires_grad_(True)
    out = fn(x)
    return out, torch.autograd.grad(out, x, g)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regroup_backward_is_autograds_indexing_backward(dtype, capture):
    """Every padded slot points at row 0 (duplicates accumulate there):
    the spanned gathers' outputs and gradients equal plain indexing bit
    for bit, on the single-class and the classed plan, and each backward
    is one ``regroup.bwd`` span."""
    single, classed = _plans()
    g = torch.Generator().manual_seed(1)
    C = 6
    hs = torch.randn(5, 9, C, generator=g).to(dtype)
    for plan in (single, classed.classes[1]):
        su = torch.from_numpy(plan.seg_utt).long()
        st = torch.from_numpy(plan.seg_tok)  # int32, as the batches carry
        assert int((su == 0).sum()) > 1
        cot = torch.randn(len(su), C, generator=g).to(dtype)
        got = _grad(lambda x: regroup.gather_token_vectors(x, su, st), hs,
                    cot)
        want = _grad(lambda x: x[su, st], hs, cot)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gather = torch.from_numpy(single.utt_gather)
    mask = torch.from_numpy(single.utt_mask)
    seg = torch.randn(64, 12, C, generator=g).to(dtype)
    cot = torch.randn(*gather.shape, C, generator=g).to(dtype)
    got = _grad(lambda x: regroup.scatter_frames(x, gather, mask), seg, cot)
    want = _grad(lambda x: x.reshape(-1, C)[gather]
                 * mask[..., None].to(dtype), seg, cot)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cg = torch.from_numpy(classed.utt_gather)
    cm = torch.from_numpy(classed.utt_mask)
    segs = [torch.randn(c.seg_utt.shape[0], c.dur_cap, C,
                        generator=g).to(dtype) for c in classed.classes]
    sizes = [s.numel() for s in segs]
    flat = torch.cat([s.reshape(-1) for s in segs])

    def classed_fn(x, scatter):
        parts = [p.reshape(s.shape) for p, s in
                 zip(torch.split(x, sizes), segs)]
        return scatter(parts)

    cot = torch.randn(*cg.shape, C, generator=g).to(dtype)
    got = _grad(lambda x: classed_fn(
        x, lambda ps: regroup.scatter_frames_classed(ps, cg, cm)), flat, cot)
    want = _grad(lambda x: classed_fn(
        x, lambda ps: torch.cat([p.reshape(-1, C) for p in ps])[cg]
        * cm[..., None].to(dtype)), flat, cot)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert capture.counts == {"regroup.bwd": 4}


def _scan_args(capture_kd, seed=0, P=5, S=4, H=8, u=6, W=3):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (0.3 * torch.randn(*shape, generator=g)).requires_grad_(True)

    spec = rnn_vjp.ScanSpec(dlayers=2, dunits=H, zoneout_rate=0.1,
                            train=True, append_position=True,
                            use_enc_out=True, capture_kd=capture_kd)
    layers = ((r(4 * H, H), r(4 * H)),
              (r(4 * H, H), r(4 * H, H), r(4 * H), r(4 * H)))
    weights = (r(4 * H, u), r(4 * H), r(W, H), layers)
    keep = torch.rand(S, 4, P, H, generator=g) < 0.1
    return (spec, weights, r(P, 4 * H), r(P, W), r(S, P, u),
            torch.rand(S, P, generator=g), keep)


def _leaves(args):
    _, weights, enc_gates, enc_out, prenet, _, _ = args
    w_pre, w_pos, wf_z, layers = weights
    return [enc_gates, enc_out, prenet, w_pre, w_pos, wf_z,
            *[t for layer in layers for t in layer]]


def _run_scan(fn, args):
    res = fn(*args)
    res = res if isinstance(res, tuple) else (res,)
    g = torch.Generator().manual_seed(7)
    loss = sum((torch.randn(o.shape, generator=g) * o).sum() for o in res)
    return res, torch.autograd.grad(loss, _leaves(args))


class _NoSpan:
    """``backward_span`` without its identities: the scan as before."""

    def __init__(self, name):
        pass

    def inputs(self, *ts):
        return ts

    def outputs(self, *ts):
        return ts


@pytest.mark.parametrize("capture_kd", [False, True], ids=["plain", "kd"])
def test_scans_are_unchanged_by_their_spans(capture_kd, capture,
                                            monkeypatch):
    """The hand-built scan with marks captured equals the same scan run
    eagerly, and the plain scan (with and without remat) equals itself
    without the backward span's identities, outputs and gradients bit for
    bit; the captures record the scans' spans."""
    args = _scan_args(capture_kd)

    def plain(remat):
        return lambda *a: rnn_vjp.scan_plain(*a, remat=remat)

    capture.begin()
    got = [_run_scan(rnn_vjp.zoneout_lstm_scan, args)]
    assert capture.counts == {"scan.fwd": 1, "scan.bwd": 1}
    got += [_run_scan(plain(remat), args) for remat in (False, True)]
    assert capture.counts == {"scan.fwd": 3, "scan.bwd": 3}
    capture.end()
    monkeypatch.setattr(spans, "_active", None)
    want = [_run_scan(rnn_vjp.zoneout_lstm_scan, args)]
    monkeypatch.setattr(rnn_vjp, "backward_span", _NoSpan)
    want += [_run_scan(plain(remat), args) for remat in (False, True)]
    for res, ref in zip(got, want):
        for a, b in zip(res[0] + res[1], ref[0] + ref[1]):
            assert torch.equal(a, b)


def _shared_weight_grads(remat):
    """Two plain scans sharing one set of bf16 weights cast from fp32
    leaves, as the duration classes share the decoder's under bf16
    compute: the fp32 leaves' gradients."""
    spec, weights, *first = _scan_args(False, seed=1)
    _, _, *second = _scan_args(False, seed=2)
    w_pre, w_pos, wf_z, layers = weights
    leaves = [w_pre, w_pos, wf_z, *[t for layer in layers for t in layer]]

    def bf(t):
        return t if t.dtype == torch.bool else t.to(torch.bfloat16)

    shared = (bf(w_pre), bf(w_pos), bf(wf_z),
              tuple(tuple(bf(t) for t in layer) for layer in layers))
    g = torch.Generator().manual_seed(7)
    loss = 0.0
    for enc_gates, enc_out, prenet, pos, keep in (first, second):
        outs = rnn_vjp.scan_plain(spec, shared, bf(enc_gates), bf(enc_out),
                                  bf(prenet), bf(pos), keep, remat=remat)
        loss = loss + (bf(torch.randn(outs.shape, generator=g))
                       * outs).float().sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_scans_sharing_weights_sum_their_gradients_unspanned(remat,
                                                             monkeypatch):
    """Scans that share their weights (one a duration class) give the
    weights the gradients they get without the spans' identities, bit
    for bit in bf16: each weight's per-step gradients add up in one
    buffer in the unspanned order (summed per scan first, as through an
    identity at the weights, they round otherwise)."""
    got = _shared_weight_grads(remat)
    monkeypatch.setattr(rnn_vjp, "backward_span", _NoSpan)
    want = _shared_weight_grads(remat)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_graphed_replay_bookkeeping():
    """``_Entry`` keeps a key's first replay as its upload, sums the rest,
    and only counts a replay under a profiler; ``stats`` reads the spans
    of the capture's regions over the untraced replays, and ``hold`` /
    ``restore`` give a traced replay's slots back."""
    card = FakeCard()
    cap = spans.Capture(card, card.launch)
    cap.begin()
    cap.enter("x")
    cap.exit()
    cap.end()
    assert (cap.last, cap.stop) == (0, 3)
    entry = graphs._Entry(None, [], None, {}, [], 0.5, 0, cap)
    for ns, traced in ((900, False), (40, False), (7000, True),
                       (60, False)):
        entry.count_replay(ns, traced)
    assert (entry.replays, entry.traced, entry.timed) == (4, 1, 2)
    assert (entry.upload_ns, entry.launch_ns) == (900, 100)
    g = graphs.Graphed(lambda x, gen: x, "cpu", "toy")
    g.entries[("k",)] = entry
    values = [0] * card.used
    values[cap.regions["x"]], values[cap.regions[OTHER]] = 30, 12
    (row,) = g.stats(values)
    assert row["launch_ns"] == 100 and row["upload_ns"] == 900
    assert (row["replays"], row["traced"], row["timed"]) == (4, 1, 2)
    assert row["spans"] == {OTHER: {"ns": 12, "count": 3},
                            "x": {"ns": 30, "count": 3}}
    assert g in graphs.live()
    card.slots[:4] = torch.tensor([5, 6, 7, 8])
    held = cap.hold()
    card.slots[:4] += 100
    cap.restore(held)
    assert card.slots[:4].tolist() == [5, 6, 7, 108]


def test_nothing_captured_reads_nothing():
    """A CPU run captures nothing: ``totals()`` and every reader that
    reads the spans give None."""
    g = graphs.Graphed(lambda x, gen: x * 2, "cpu", "tts_batch")
    assert torch.equal(g(None, torch.ones(2)), torch.full((2,), 2.0))
    assert spans.totals() is None
    spec = harness.load_spec(harness.os.path.dirname(harness.HERE))
    for name in NEW_METRICS:
        entry = next(m for m in spec["per_layer"] if m["name"] == name)
        cell = entry["workloads"][0]
        _, config, mix, _, _ = harness.resolve(spec, cell)
        run = harness.Run(config, mix)
        run.calls, run.window_s = [{"utts": [(70, 560)]}], 0.1
        assert harness.load_module("metrics", name).read(run) is None


SA_KEYS = {"replays", "traced", "launch_ns", "timed", "upload_ns",
           "device_ns", "spans"}


def _graph_on_card(monkeypatch, name, build):
    """A ``Graphed`` whose one capture ``build(cap)`` records, reported as
    on the card (``totals`` reads its slots through ``spans.read``)."""
    card = FakeCard()
    cap = spans.Capture(card, card.launch)
    monkeypatch.setattr(spans, "_active", cap)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    cap.begin()
    build(cap)
    cap.end()
    monkeypatch.setattr(spans, "_active", None)
    g = graphs.Graphed(lambda x, gen: x, "cpu", name)
    g.entries[("k",)] = graphs._Entry(None, [], None, {}, [], 0.1, 0, cap)
    g.entries[("k",)].count_replay(10, False)
    g.device = torch.device("cuda")
    return g, cap, card


def test_counters_land_in_the_totals_of_their_graph(monkeypatch):
    """``spans.count`` inside a capture adds to slots of the graph's own
    (inside what a traced replay holds and gives back); ``totals()``
    reports them under ``counters`` for that graph alone, and an SA
    graph's totals keep their keys."""
    def t2(cap):
        with span("serve.decoder"):
            pass
        spans.count("ar.steps", torch.tensor([9], dtype=torch.int32))
        spans.count("ar.frames", torch.tensor([9, 4, 7], dtype=torch.int32))

    def sa(cap):
        with span("serve.decoder"):
            pass

    g2, cap, card = _graph_on_card(monkeypatch, "synthesize", t2)
    slots = set(cap.counters.values())
    assert set(cap.counters) == {"ar.steps", "ar.frames"}
    assert slots < set(range(cap.last, cap.stop))
    assert [int(card.slots[s]) for s in sorted(slots)] == [9, 20]
    g1, _, card1 = _graph_on_card(monkeypatch, "tts_batch", sa)
    rows = {}
    for g, c in ((g2, card), (g1, card1)):  # each graph's own slots
        monkeypatch.setattr(graphs, "live", lambda g=g: [g])
        monkeypatch.setattr(spans, "read", lambda dev, c=c: c.slots.tolist())
        rows[g.name] = spans.totals()[g.name]
    assert rows["synthesize"]["counters"] == {"ar.steps": 9, "ar.frames": 20}
    assert set(rows["synthesize"]) == SA_KEYS | {"counters"}
    assert set(rows["tts_batch"]) == SA_KEYS
    assert "serve.decoder" in rows["tts_batch"]["spans"]


def test_a_count_outside_a_capture_is_nothing():
    spans.count("ar.steps", torch.tensor([3]))
    assert spans.totals() is None
