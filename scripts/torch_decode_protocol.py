#!/usr/bin/env python3
"""Full-shard serving protocol of the PyTorch port (the port's copy of
``scripts/decode_protocol.py``): split a manifest with ``fcl_splitjson``,
decode every shard with ``fcl_synth``, and record the per-utterance
speed distribution (p5/p50/p95 of each utterance's frames over its
batch's wall, from the decode.txt lines), not only the mean.  Each shard
is its own ``fcl_synth`` call, so shard 1 carries the process's first
calls (kernel builds excluded: they happen once a process).

    python3 scripts/torch_decode_protocol.py \
        --model WD/exp_teacher/model.loss.best \
        --json WD/features/test_data.json [--parts 10] [--batch-size 8] \
        [--device cuda] [--out results/TORCH_DECODE_protocol.json]
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def read_decode_txt(path):
    """decode.txt -> (per-utterance frames, per-utterance frames/s, mean
    frames/s, total frames/s)."""
    frames, fps, mean, total = [], [], None, None
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if parts[0] == "mean_frames_per_sec":
                mean = float(parts[1])
            elif parts[0] == "total_frames_per_sec":
                total = float(parts[1])
            elif len(parts) >= 7 and parts[1] == "frames":
                # "<utt> frames <n> batch_wall_sec <t> frames_per_sec <fps>"
                frames.append(int(parts[2]))
                fps.append(float(parts[6]))
    return frames, fps, mean, total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--json", required=True)
    p.add_argument("--parts", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--label", type=str, default="teacher")
    p.add_argument("--extra-synth", nargs="*", default=[],
                   help="extra fcl_synth flags; dash-leading values use "
                        "the = form with quoting, e.g. "
                        "--extra-synth='--decoder-backend hybrid' "
                        "(each element is whitespace-split)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--workdir", type=str, default=os.path.join(
        tempfile.gettempdir(), "fcl_torch_decode_proto"))
    p.add_argument("--out", type=str, default=os.path.join(
        REPO, "results", "TORCH_DECODE_protocol.json"))
    args = p.parse_args(argv)
    args.extra_synth = [t for s in args.extra_synth for t in s.split()]

    from torch_mcd_benchmark import device_info, require_device
    require_device(args.device)
    from fcl_taco2_tpu_torch.cli import fcl_splitjson, fcl_synth

    fcl_splitjson.main([args.json, "--parts", str(args.parts)])
    base = os.path.basename(args.json).rsplit(".", 1)[0]
    split_dir = os.path.join(os.path.dirname(args.json),
                             f"split{args.parts}utt")
    shards = sorted(glob.glob(os.path.join(split_dir, f"{base}.*.json")),
                    key=lambda s: int(s.rsplit(".", 2)[1]))
    if len(shards) != args.parts:
        raise RuntimeError(f"expected {args.parts} shards, got {shards}")

    utt_fps, utt_frames, shard_means, shard_totals = [], [], [], []
    t0 = time.time()
    for k, shard in enumerate(shards):
        out_dir = os.path.join(args.workdir, f"shard{k + 1}")
        fcl_synth.main(["--model", args.model, "--json", shard,
                        "--out", out_dir, "--batch-size",
                        str(args.batch_size), "--no-ark",
                        "--device", args.device, *args.extra_synth])
        frames, fps, mean, total = read_decode_txt(
            os.path.join(out_dir, "decode.txt"))
        utt_frames += frames
        utt_fps += fps
        shard_means.append(mean)
        shard_totals.append(total)
        print(f"shard {k + 1}/{args.parts}: {len(utt_fps)} utts so far",
              flush=True)
    wall = time.time() - t0

    fps = np.asarray(utt_fps)
    payload = {
        "protocol": {
            "what": "fcl_splitjson -> fcl_synth over every shard of a "
                    "manifest; per-utterance frames/sec from each "
                    "utterance's frames over its batch's wall clock "
                    "(decode.txt lines), one batch in flight while the "
                    "previous one is read back",
            "model": args.label,
            "ckpt": args.model,
            "json": args.json,
            "parts": args.parts,
            "batch_size": args.batch_size,
            "extra_synth": args.extra_synth,
            "device": device_info(args.device),
        },
        "n_utts": len(utt_fps),
        "total_frames": int(np.sum(utt_frames)),
        "total_wall_sec": round(wall, 1),
        "total_frames_per_sec": round(float(np.sum(utt_frames)) / wall, 1),
        "per_utt_frames_per_sec": {
            "p5": round(float(np.percentile(fps, 5)), 1),
            "p50": round(float(np.percentile(fps, 50)), 1),
            "p95": round(float(np.percentile(fps, 95)), 1),
            "mean": round(float(fps.mean()), 1),
        },
        "per_shard_mean_fps": [round(m, 1) for m in shard_means],
        "per_shard_pipelined_total_fps": [round(m, 1)
                                          for m in shard_totals],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload["per_utt_frames_per_sec"]))
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
