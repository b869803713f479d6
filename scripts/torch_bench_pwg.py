#!/usr/bin/env python3
"""The PWG vocoder's paths on one NVIDIA GPU (scripts/bench_pwg.py's
protocol, the port's vocoder).

    python3 scripts/torch_bench_pwg.py [--reps 5] [--frames 512] [--seed 0]
                                       [--smoke]
                                       [--out results/TORCH_PWG_vocoder.json]

PWG v1 (``PWGConfig()``, seeded weights, fp32) on a random mel of
``--frames`` frames at B = 1 and 8, fresh noise drawn on the card for
every call.  Paths, timed in turns at each B:

- ``full``: ``vocoder/pwg.py::pwg_generate``, the whole utterance through
  PyTorch's own convolutions (cuDNN), TF32 off (fp32 products, the
  kernel's accuracy);
- ``full_tf32``: the same with TF32 allowed (cuDNN and cuBLAS);
- ``chunk128``: ``pwg_generate_chunked(..., 128, 40)``;
- ``kernel``: ``vocoder/pwg_cuda.py::pwg_generate_streaming`` (the
  upsampler, then one launch of ``csrc/pwg_stream.cu``), weights packed
  once, as the serving paths hold them.

Each reading is ``ITERS`` calls between two synchronizations of the
card (host clock); ms a call and Msamples/s with their median, min, max
and count.  Needs the card: without one it raises.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import tf32  # noqa: E402

SAMPLE_RATE = 22050
ITERS = 3  # calls a reading


def pwg_rows(B, frames, reps, iters=ITERS, seed=0):
    """One row a path at batch ``B``, the paths timed in turns."""
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 pwg_generate,
                                                 pwg_generate_chunked)
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import (pack_pwg_weights,
                                                      pwg_generate_streaming)
    cfg = PWGConfig()
    pwg = ParallelWaveGAN(cfg, seed=seed)
    packed = pack_pwg_weights(pwg, cfg)
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(
        rng.normal(size=(B, frames, cfg.aux_channels)).astype(
            np.float32)).cuda()
    W = frames * cfg.hop
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noise():
        return torch.randn(B, W, device="cuda", generator=gen)

    def full(allow):
        def call():
            with tf32(allow):
                return pwg_generate(pwg, cfg, mel, noise())
        return call

    paths = {
        "full": full(False), "full_tf32": full(True),
        "chunk128": lambda: pwg_generate_chunked(pwg, cfg, mel, noise(),
                                                 128, 40),
        "kernel": lambda: pwg_generate_streaming(pwg, cfg, mel, noise(),
                                                 tile=1024, packed=packed),
    }
    with tf32(False), torch.no_grad():  # chunk128 at fp32, as full
        per = timing.interleaved_ms(paths, reps, iters)
    rows = []
    for name, ms in per.items():
        rows.append({
            "name": name, "path": name, "B": B, "frames": frames,
            "samples": B * W, "ms": timing.spread(ms),
            "msamples_per_sec": timing.spread(
                [B * W / (m / 1e3) / 1e6 for m in ms]),
            "x_realtime_total_median": B * W / SAMPLE_RATE
            / (float(np.median(ms)) / 1e3),
            "card": timing.card()["smi"]})
    return rows


def smoke(seed=0):
    """B = 1, one reading of one call a path."""
    return pwg_rows(1, 512, 1, 1, seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO, "results",
                                                 "TORCH_PWG_vocoder.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    rows = [r for B in (1, 8)
            for r in pwg_rows(B, args.frames, args.reps, seed=args.seed)]
    payload = {"card": timing.card(), "seed": args.seed,
               "protocol": {"sr": SAMPLE_RATE, "frames": args.frames,
                            "reps": args.reps, "iters": ITERS,
                            "timing": "synchronized host clock around "
                                      "ITERS calls, paths in turns; "
                                      "fresh noise a call"},
               "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
