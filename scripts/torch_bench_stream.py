#!/usr/bin/env python3
"""Streaming TTS latency on one NVIDIA GPU (scripts/bench_stream.py's
protocol, the port's ``StreamTTS``).

    python3 scripts/torch_bench_stream.py [--trials 200] [--seed 0]
                                          [--smoke]
                                          [--out results/TORCH_STREAM_tts.json]

``StreamTTS`` at its defaults (16 phonemes a decode chunk, 16 frames =
4096 samples a vocoder step, readback depth 1) on FCL-taco2-S in bf16
with PWG v1 in fp32, idim 45, odim 80, seeded weights; utterances of 16,
64 and 192 phonemes with Poisson(5) durations clipped to 1..max_dur; then
FCL-taco2-T in bf16 (``fused_ar_decode_hbm``), plain and int8, at 64
phonemes.  Each case is warmed up once (every stage's CUDA graph
captured), then streamed ``--trials`` times with a fresh seed each: time
to first audio (the wall clock from the call to the first chunk in host
memory), the real-time factor over the whole stream and over its steady
state (after the first chunk), chunks an utterance.  Each timing carries
its median, min, max, count and p90 / p95 (``--trials`` >= 200 leaves ten
samples beyond the p95).  Needs the card: without one it raises.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402

IDIM, ODIM = 45, 80
SAMPLE_RATE = 22050
CASES = (("short_utt_16ph", 16), ("typical_utt_64ph", 64),
         ("long_utt_192ph", 192))
TEACHER_PHONES = 64


def measure(st, tokens, dur, trials, name):
    """Stream ``tokens`` ``trials`` times (seeds 1..trials) after one
    warm-up; the row of its timings."""
    st.tts(tokens, 0, durations=dur)  # captures every stage's graph
    ttfa, rtf, steady = timing.Readings(), [], []
    n_chunks = set()
    first = total = 0
    for t in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_first = None
        total = chunks = 0
        for chunk in st.stream(tokens, t + 1, durations=dur):
            if t_first is None:
                t_first = time.perf_counter() - t0
                first = chunk.size
            total += chunk.size
            chunks += 1
        wall = time.perf_counter() - t0
        ttfa.add(1e3 * t_first)
        rtf.append(wall / (total / SAMPLE_RATE))
        if total > first:
            steady.append((wall - t_first)
                          / ((total - first) / SAMPLE_RATE))
        n_chunks.add(chunks)
    row = {"name": name, "ttfa_ms": timing.spread(ttfa),
           "rtf": timing.spread(rtf), "steady_rtf": timing.spread(steady),
           "x_realtime_median": 1.0 / float(np.median(rtf)),
           "first_chunk_samples": int(first), "audio_s": total / SAMPLE_RATE,
           "n_wav_chunks": sorted(n_chunks), "n_phones": len(tokens),
           "n_frames": int(dur.sum()), "card": timing.card()["smi"]}
    if len(ttfa) >= 20:
        row["ttfa_ms"]["p95"] = float(np.percentile(ttfa, 95))
        row["ttfa_ms"]["p50"] = float(np.percentile(ttfa, 50))
    return row


def _utterance(rng, n, max_dur):
    tokens = rng.integers(1, IDIM, n).astype(np.int32)
    dur = np.clip(rng.poisson(5.0, n), 1, max_dur).astype(np.int32)
    return tokens, dur


def _pwg():
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    return ParallelWaveGAN(PWGConfig(), seed=1)


def student_rows(trials, seed=0, cases=CASES):
    """FCL-taco2-S bf16 + PWG v1 through ``StreamTTS`` defaults, one row
    an utterance length."""
    from fcl_taco2_tpu_torch.infer import StreamTTS
    from fcl_taco2_tpu_torch.models import Tacotron2SA, student_config
    model = Tacotron2SA(student_config(IDIM, odim=ODIM,
                                       compute_dtype="bfloat16"), seed=0)
    st = StreamTTS(model, _pwg())
    rng = np.random.default_rng(seed)
    rows = []
    for name, n in cases:
        tokens, dur = _utterance(rng, n, model.cfg.max_dur)
        rows.append(measure(st, tokens, dur, trials, name))
        rows[-1]["model"] = "FCL-taco2-S bf16 + PWG v1 fp32"
    return rows, {"chunk_phonemes": st.Pc, "postnet_chunk": st.Fc,
                  "vocode_frames": st.Fv, "tile": st.tile, "hop": st.hop,
                  "vocoder_delay_samples": st.delay,
                  "vocoder_delay_ms": st.delay / SAMPLE_RATE * 1e3,
                  "readback_depth": st.readback_depth}


def teacher_rows(trials, seed=0, quantizes=("none", "int8")):
    """FCL-taco2-T bf16 at 64 phonemes: each 16-phoneme chunk runs the
    streaming decoder kernel, in bf16 and int8."""
    from fcl_taco2_tpu_torch.infer import StreamTTS
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    model = Tacotron2SA(teacher_config(IDIM, odim=ODIM,
                                       compute_dtype="bfloat16"), seed=2)
    pwg = _pwg()
    tokens, dur = _utterance(np.random.default_rng(seed + 1),
                             TEACHER_PHONES, model.cfg.max_dur)
    rows = []
    for q in quantizes:
        st = StreamTTS(model, pwg, quantize=q)
        name = f"teacher_utt_{TEACHER_PHONES}ph" + \
            ("_int8" if q == "int8" else "")
        rows.append(measure(st, tokens, dur, trials, name))
        rows[-1]["model"] = f"FCL-taco2-T bf16, quantize={q}"
    return rows


def smoke(seed=0):
    """One length of each model, two trials."""
    rows, _ = student_rows(2, seed, cases=CASES[1:2])
    return rows + teacher_rows(2, seed, quantizes=("none",))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO, "results",
                                                 "TORCH_STREAM_tts.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    rows, config = student_rows(args.trials, args.seed)
    rows += teacher_rows(args.trials, args.seed)
    payload = {"card": timing.card(), "seed": args.seed,
               "config": config, "trials": args.trials,
               "timing": "wall clock around the generator's yields; each "
                         "yield is a chunk in host memory (its copy "
                         "waited for); the first trial follows a warm-up "
                         "that captured every stage's CUDA graph",
               "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
