"""``benchmark/counts/tacotron2.py`` against operations and bytes counted
by hand at a tiny shape, and the new cell's readers on a hand-made run."""

from benchmark import harness
from benchmark.counts import tacotron2
from benchmark.tests.tiny import ROOT

MC = {"embed_dim": 4, "econv_layers": 1, "econv_chans": 6, "econv_filts": 3,
      "elayers": 1, "eunits": 8, "dunits": 5, "prenet_units": 3, "odim": 2,
      "postnet_layers": 2, "postnet_chans": 7, "postnet_filts": 3,
      "adim": 6, "aconv_chans": 2, "aconv_filts": 1}


def test_tacotron2_counts_by_hand():
    L, frames = 3, 10
    enc = L * 2 * 4 * 6 * 3 + 2 * L * 2 * (6 + 4) * 16  # conv + BiLSTM h=4
    memory = L * 2 * 8 * 6
    # a position: the location conv (2 channels, 3 taps), its projection
    # to 6, gvec, the context over 8 channels
    position = 2 * 2 * 3 + 2 * 2 * 6 + 2 * 6 + 2 * 8
    step = (2 * 5 * 6 + L * position + 2 * (2 * 3 + 3 * 3)
            + 2 * (8 + 3 + 5) * 20 + 2 * 10 * 20 + 2 * 13 * 3)
    assert tacotron2.decoder_step_flops(MC, L) == step
    post = frames * (2 * 2 * 7 * 3 + 2 * 7 * 2 * 3)
    assert tacotron2.synth_flops(MC, L, frames) == (
        enc + memory + frames * step + post)
    weights = (5 * 6 + 2 * 3 + 2 * 6 + 6 + 2 * 3 + 3 * 3 + (8 + 3 + 5) * 20
               + 2 * 5 * 20 + 13 * 3)
    utt = L * (8 * 2 + 6 * 4) + frames * 3 * 4
    assert tacotron2.decoder_loop_bytes(MC, [(L, frames)], 2) == \
        2 * weights + utt


def test_the_cells_readers_on_a_hand_made_run():
    """The roofline and the whole call's share read a traced run by hand;
    the span and counter readers find nothing to read on the CPU."""
    spec = harness.load_spec(ROOT)
    cell, config, mix, _, _ = harness.resolve(spec, "tacotron2-synth-b16")
    mc = config["model"]
    run = harness.Run(config, mix)
    run.calls, run.window_s = [{"utts": [(70, 560), (12, 96)]}], 0.5
    run.traced = {"dev": [("attn_decode_kernel", 0, 20_000_000)],
                  "window_s": 0.03, "calls": run.calls, "idle_gaps": []}
    flops = 560 * tacotron2.decoder_step_flops(mc, 70) \
        + 96 * tacotron2.decoder_step_flops(mc, 12)
    nbytes = tacotron2.decoder_loop_bytes(mc, [(70, 560), (12, 96)], 2)
    least = max(flops / 989e12, nbytes / 3.35e12)
    got = harness.load_module("metrics", "t2_decoder_roofline.t2synth")
    assert abs(got.read(run) - 100 * least / 0.02) < 1e-9
    whole = tacotron2.synth_flops(mc, 70, 560) \
        + tacotron2.synth_flops(mc, 12, 96)
    mfu = harness.load_module("metrics", "mfu.t2synth").read(run)
    assert abs(mfu - 100 * whole / 0.5 / 989e12) < 1e-9
    others = [m["name"] for m in harness.cell_metrics(spec, cell, True)
              if m["name"] not in ("t2_decoder_roofline.t2synth",
                                   "mfu.t2synth")]
    assert sorted(others) == [
        "decoder_ms.synth", "frontend_ms.synth", "launch_ms.synth",
        "postnet_ms.synth", "span_idle_pct.synth",
        "t2_step_fill_pct.t2synth"]
    for name in others:
        assert harness.load_module("metrics", name).read(run) is None
