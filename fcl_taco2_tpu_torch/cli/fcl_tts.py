#!/usr/bin/env python3
"""End-to-end TTS: manifest -> wav in one process; port of
``fcl_taco2_tpu/cli/fcl_tts.py`` with the same flags, plus ``--device``.

    python -m fcl_taco2_tpu_torch.cli.fcl_tts --model EXP/model.loss.best \
        --json data.json --outdir WAVS [--stream] [--device cpu]

The batch path runs ``TTSPipeline.tts_batch`` (acoustic model + the
streaming PWG kernel) and prints the median realtime factor; ``--stream``
runs ``StreamTTS`` utterance by utterance (the PWG stream-step kernel) and
prints the median time to first audio and x realtime.  Raises when no
card is present unless ``--device cpu`` is given.
"""

import argparse
import os

from fcl_taco2_tpu_torch.cli.fcl_vocode import write_wav


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, required=True,
                   help="acoustic checkpoint (snapshot / model.loss.best)")
    p.add_argument("--model-conf", type=str, default=None)
    p.add_argument("--json", type=str, required=True,
                   help="manifest with tokenids to synthesize")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--pwg-checkpoint", type=str, default=None,
                   help="official ParallelWaveGAN .pkl (random init if "
                        "omitted; smoke runs only)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--pwg-config", type=str, default=None,
                   help="json with PWGConfig field overrides (layers, "
                        "upsample_scales, ...) for non-default vocoders")
    p.add_argument("--stream", action="store_true",
                   help="low-latency path: per-utterance chunked "
                        "synthesis through infer.stream.StreamTTS instead "
                        "of whole batches")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8: weight-only quantized decode on the "
                        "weight-streaming decoder kernel (teacher-size "
                        "models)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda, which must be "
                        "present; cpu runs the plain PyTorch versions)")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    import time

    import numpy as np

    from fcl_taco2_tpu_torch.cli.fcl_synth import load_acoustic_model
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.infer import StreamTTS, TTSPipeline
    from fcl_taco2_tpu_torch.ops.rnn import step_seed
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 load_pwg_checkpoint)

    model = load_acoustic_model(args.model, args.model_conf, args.device)
    pwg_over = {"aux_channels": model.cfg.odim}
    if args.pwg_config:
        import json
        with open(args.pwg_config) as f:
            pwg_over.update(json.load(f))
        if "upsample_scales" in pwg_over:
            pwg_over["upsample_scales"] = tuple(pwg_over["upsample_scales"])
    pwg_cfg = PWGConfig(**pwg_over)
    if args.pwg_checkpoint:
        pwg = load_pwg_checkpoint(args.pwg_checkpoint, pwg_cfg,
                                  device=args.device)
    else:
        print("WARNING: no --pwg-checkpoint; vocoder has random weights")
        pwg = ParallelWaveGAN(pwg_cfg, device=args.device, seed=0)

    utts = load_manifest(args.json)
    os.makedirs(args.outdir, exist_ok=True)

    if args.stream:
        st = StreamTTS(model, pwg, pwg_cfg, quantize=args.quantize,
                       device=args.device)
        ttfas, rtfs = [], []
        for i, u in enumerate(utts):
            t0 = time.perf_counter()
            ttfa = None
            chunks = []
            for c in st.stream(np.asarray(u.tokenids, np.int64),
                               step_seed(args.seed, i)):
                if ttfa is None:
                    ttfa = time.perf_counter() - t0
                chunks.append(c)
            dt = time.perf_counter() - t0
            wav = (np.concatenate(chunks) if chunks
                   else np.zeros(0, np.float32))
            if wav.size:
                rtfs.append(wav.size / args.sample_rate / dt)
                ttfas.append(ttfa)
            write_wav(os.path.join(args.outdir, f"{u.uttid}.wav"), wav,
                      args.sample_rate)
        stats = {"ttfa_ms": float(np.median(ttfas)) * 1e3,
                 "rtf_x": float(np.median(rtfs))}
        print(f"streamed {len(utts)} utts, median TTFA "
              f"{stats['ttfa_ms']:.1f} ms, median "
              f"{stats['rtf_x']:.1f}x realtime -> {args.outdir}")
        return stats

    pipe = TTSPipeline(model, pwg, pwg_cfg, sample_rate=args.sample_rate,
                       quantize=args.quantize, device=args.device)
    rtfs = []
    for k, i in enumerate(range(0, len(utts), args.batch_size)):
        chunk = utts[i:i + args.batch_size]
        wavs, stats = pipe.tts_batch([u.tokenids for u in chunk],
                                     step_seed(args.seed, k))
        rtfs.append(stats["rtf_x"])
        for u, w in zip(chunk, wavs):
            write_wav(os.path.join(args.outdir, f"{u.uttid}.wav"), w,
                      args.sample_rate)
    stats = {"rtf_x": float(np.median(rtfs))}
    print(f"synthesized {len(utts)} utts, median RTF "
          f"{stats['rtf_x']:.1f}x realtime -> {args.outdir}")
    return stats


if __name__ == "__main__":
    main()
