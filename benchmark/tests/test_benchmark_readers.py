"""The traced window's interval arithmetic and the metric readers on
hand-made runs: each reader's number from known events and counts, and
nothing (no zero) where there is nothing to read."""

import pytest

from benchmark import harness, trace
from benchmark.counts import pwg, taco2
from benchmark.counts.peaks import FP32_3XTF32_FLOPS, bound_s

EVENTS = [("void pwg_stream_kernel<8>(PwgArgs)", 0, 4_000_000),
          ("elementwise_kernel<MulFunctor>", 3_000_000, 5_000_000),
          ("Memcpy DtoH (Device -> Pinned)", 7_000_000, 8_000_000),
          ("void ar_decode_kernel<float>(DecodeArgs, int)",
           10_000_000, 11_000_000)]


def test_union_gaps_and_host_attribution():
    assert trace.busy_s(EVENTS) == pytest.approx(7e-3)
    assert trace.gaps(EVENTS) == [(5_000_000, 7_000_000),
                                  (8_000_000, 10_000_000)]
    host = [("cudaGraphLaunch", 4_500_000, 6_500_000, 1),
            ("bench.call", 0, 20_000_000, 1),
            ("cudaStreamSynchronize", 5_500_000, 6_200_000, 1)]
    # the innermost op spanning each gap's middle takes the gap
    assert trace.idle_by_host(EVENTS, host) == [
        ["cudaStreamSynchronize", pytest.approx(2e-3)],
        ["bench.call", pytest.approx(2e-3)]]
    assert trace.kernel_label("void at::native::elementwise_kernel<128, 4, "
                              "at::native::MulFunctor<float>>()") == \
        "elementwise_kernel:MulFunctor"
    assert trace.top_device_ops(EVENTS, 2)[0] == [
        "pwg_stream_kernel", pytest.approx(4e-3)]


def _run(cell, traced=True):
    spec = harness.load_spec(harness.os.path.dirname(harness.HERE))
    _, config, mix, _, _ = harness.resolve(spec, cell)
    run = harness.Run(config, mix)
    run.calls = [{"utts": [(70, 560)]}, {"utts": [(100, 800)]}]
    run.latencies = [0.02, 0.04]
    run.window_s = 0.1
    if traced:
        run.traced = {"dev": EVENTS, "window_s": 0.02,
                      "calls": run.calls[:1], "idle_gaps": []}
    return run


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_readers_on_a_hand_made_run():
    run = _run("student-tts-b1")
    vc, mc = run.config["vocoder"], run.config["model"]
    samples = 560 * pwg.hop(vc)
    least = bound_s(samples * pwg.stack_flops_per_sample(vc),
                    pwg.stack_bytes(vc, samples), FP32_3XTF32_FLOPS)
    assert read("pwg_roofline.tts", run) == pytest.approx(
        100 * least / 4e-3)
    assert read("tts_p95_ms", run) == pytest.approx(39.0)
    assert read("tts_p50_ms", run) == pytest.approx(30.0)
    flops = sum(taco2.synth_flops(mc, L, f) + pwg.vocode_flops(vc, f)
                for L, f in ((70, 560), (100, 800)))
    assert read("mfu.tts", run) == pytest.approx(100 * flops / 0.1 / 989e12)
    synth = _run("teacher-synth-b16")
    assert read("synth_frames_per_s", synth) == pytest.approx(13600)
    assert read("model_other_ms.synth", synth) == pytest.approx(2.0)
    assert 0 < read("decoder_roofline.synth", synth) < 100


@pytest.mark.parametrize("name", ["pwg_roofline.tts",
                                  "decoder_roofline.synth",
                                  "model_other_ms.synth"])
def test_nothing_to_read_gives_nothing(name):
    cell = "student-tts-b1" if name.endswith("tts") else "teacher-synth-b16"
    assert read(name, _run(cell, traced=False)) is None
    run = _run(cell)
    run.traced["dev"] = [e for e in EVENTS if "kernel" not in e[0]]
    if "roofline" in name:
        assert read(name, run) is None
