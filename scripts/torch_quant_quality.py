#!/usr/bin/env python3
"""Quality cost of int8 weight-only decoder quantization in the PyTorch
port (the port's copy of ``scripts/quant_quality.py``): decode the
held-out test shard with the trained teacher's weights and with the
int8-dequantized equivalent of the three streamed matrices, and report
the MCD/L1 deltas.

The method is the JAX script's: the weights of ``lstm0.wh``,
``lstm1.wx`` and ``lstm1.wh`` are cast to the checkpoint's compute dtype
(serving casts before the kernel quantizes), quantized with
``ops/decoder_cuda.py::quantize_per_column``, and ``codes * scale`` is
written as a checkpoint (``train/checkpoint.py``) that decodes through
the normal path, with the same seed; per-matrix weight SNR.  The
dequantized values get one more bf16 rounding in the decode that the
kernel does not have, so that row's delta upper-bounds the quantization's
cost.  One row JAX could not run on its CPU: the original checkpoint
decoded with ``fcl_synth --quantize int8 --decoder-backend pallas_hbm``,
i.e. through ``fused_ar_decode_hbm``'s int8 mode (the entry ``auto``
takes for the teacher on the card; on the CPU its plain version), codes
exact and scales fp32, written beside the dequantized row.

    python3 scripts/torch_quant_quality.py --workdir WD [--device cuda]

A ``--workdir`` holding a ``torch_mcd_benchmark.py`` teacher run skips to
the decodes (and reuses that run's decodes of the original checkpoint);
otherwise the corpus and teacher stages run first.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MATRICES = (("lstm0", "wh"), ("lstm1", "wx"), ("lstm1", "wh"))


def quantize_matrix(w, compute_dtype):
    """A float32 (in, out) matrix -> (codes int8, scales fp32, the
    compute-dtype weights it quantized, dequantized ``codes * scale``),
    numpy, as the serving path quantizes it."""
    import torch

    from fcl_taco2_tpu_torch.ops.decoder_cuda import quantize_per_column
    w_in = torch.from_numpy(np.asarray(w, np.float32)).to(
        compute_dtype).float()
    q, s = quantize_per_column(w_in)
    q, s, w_in = q.numpy(), s.numpy(), w_in.numpy()
    return q, s, w_in, q.astype(np.float32) * s[None, :]


def snr_db(w_in, deq):
    err = deq - w_in
    return round(float(10 * np.log10(
        np.mean(w_in ** 2) / max(np.mean(err ** 2), 1e-30))), 1)


def write_dequantized(ckpt, out, compute_dtype):
    """``ckpt`` with the three streamed matrices replaced by their int8
    dequantized equivalents, written to ``out``; returns the per-matrix
    weight SNR (dB)."""
    from fcl_taco2_tpu_torch.train.checkpoint import _write, read_checkpoint
    from fcl_taco2_tpu_torch.utils import msgpack
    payload = read_checkpoint(ckpt)
    dec = payload["params"]["decoder"]
    snr = {}
    for top, leaf in MATRICES:
        _, _, w_in, deq = quantize_matrix(dec[top][leaf], compute_dtype)
        snr[f"{top}.{leaf}"] = snr_db(w_in, deq)
        dec[top][leaf] = deq
    _write(out, msgpack.serialize(payload))
    return snr


def direct(dir_a, dir_b, mel_stats):
    """MCD and L1 between two decodes of the same utterances."""
    from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
    from fcl_taco2_tpu_torch.infer.metrics import (mel_cepstral_distortion,
                                                   mel_l1)
    mean, std = mel_stats
    with open(os.path.join(dir_b, "feats.scp")) as f:
        refs = dict(ln.split(None, 1) for ln in f)
    mcds, l1s = [], []
    with open(os.path.join(dir_a, "feats.scp")) as f:
        for ln in f:
            utt, loc = ln.split(None, 1)
            a = read_ark_matrix(loc.strip()) * std + mean
            b = read_ark_matrix(refs[utt].strip()) * std + mean
            mcds.append(mel_cepstral_distortion(a, b))
            l1s.append(mel_l1(a, b))
    return {"mcd_db": round(float(np.mean(mcds)), 3),
            "l1": round(float(np.mean(l1s)), 4)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", type=str, default=os.path.join(
        tempfile.gettempdir(), "fcl_torch_quant_run"))
    p.add_argument("--n-utts", type=int, default=240)
    p.add_argument("--n-val", type=int, default=24)
    p.add_argument("--n-test", type=int, default=24)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--teacher-config", type=str, default=None,
                   help="passed to torch_mcd_benchmark.py when a teacher "
                        "must be trained first")
    p.add_argument("--out", type=str, default=os.path.join(
        REPO, "results", "TORCH_QUANT_decode.json"))
    args = p.parse_args(argv)

    import torch_mcd_benchmark
    from torch_mcd_benchmark import decode_and_eval, device_info
    torch_mcd_benchmark.require_device(args.device)
    import torch

    from fcl_taco2_tpu_torch.train.checkpoint import load_model_json

    wd = args.workdir
    exp = os.path.join(wd, "exp_teacher")
    feat = os.path.join(wd, "features")
    ckpt = os.path.join(exp, "model.loss.best")
    t0 = time.time()
    teacher_stage_sec = None
    if not os.path.exists(ckpt):
        print(f"[train] no checkpoint in {wd}; running the corpus + "
              "teacher stages ...", flush=True)
        t1 = time.time()
        torch_mcd_benchmark.main([
            "--workdir", wd, "--stage", "teacher",
            "--n-utts", str(args.n_utts), "--n-val", str(args.n_val),
            "--n-test", str(args.n_test), "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size), "--device", args.device,
            "--out", os.path.join(wd, "mcd_teacher.json"),
            *(["--teacher-config", args.teacher_config]
              if args.teacher_config else [])])
        teacher_stage_sec = time.time() - t1

    cfg, _ = load_model_json(exp)
    compute_dtype = getattr(torch, cfg.compute_dtype)
    ckpt8 = os.path.join(exp, "model.int8eq")
    snr = write_dequantized(ckpt, ckpt8, compute_dtype)
    print(f"[quant] per-matrix weight SNR (dB): {snr}", flush=True)

    # the duration predictor is not quantized, so every variant gets the
    # same segment plan and the same prenet-dropout draws (seed 1)
    results, dirs = {}, {}
    for tag, model_path, quant in (("fp32", ckpt, []),
                                   ("int8", ckpt8, []),
                                   ("int8_kernel", ckpt,
                                    ["--quantize", "int8",
                                     "--decoder-backend", "pallas_hbm"])):
        for dur_tag, extra in (("pred_dur", []),
                               ("gt_dur", ["--use-gt-durations"])):
            # torch_mcd_benchmark's teacher stage decoded the original
            # checkpoint with these settings already
            reuse = os.path.join(wd, f"decode_{dur_tag}")
            out_dir = os.path.join(wd, f"decode_{tag}_{dur_tag}")
            if tag == "fp32" and os.path.exists(
                    os.path.join(reuse, "eval.json")):
                out_dir = reuse
                with open(os.path.join(reuse, "eval.json")) as f:
                    summary = json.load(f)["summary"]
            else:
                summary = decode_and_eval(feat, out_dir, model_path,
                                          args.device, [*extra, *quant])
                summary.pop("frames_per_sec")
            results[f"{tag}_{dur_tag}"] = summary
            dirs[(tag, dur_tag)] = out_dir

    mel_stats = np.load(os.path.join(feat, "mel_stats.npy"))
    vs_fp32 = {d: direct(dirs[("fp32", d)], dirs[("int8", d)], mel_stats)
               for d in ("pred_dur", "gt_dur")}
    kernel_vs_fp32 = {d: direct(dirs[("fp32", d)],
                                dirs[("int8_kernel", d)], mel_stats)
                      for d in ("pred_dur", "gt_dur")}
    kernel_vs_deq = {d: direct(dirs[("int8", d)],
                               dirs[("int8_kernel", d)], mel_stats)
                     for d in ("pred_dur", "gt_dur")}

    payload = {
        "protocol": {
            "what": "int8 weight-only quantization of the streamed "
                    "decoder matrices (lstm0.wh, lstm1.wx, lstm1.wh; "
                    "quantize_per_column) vs the checkpoint's weights, "
                    "same seed: 'int8' decodes the dequantized "
                    "checkpoint through the normal path (JAX's method), "
                    "'int8_kernel' the original checkpoint with "
                    "fcl_synth --quantize int8 --decoder-backend "
                    "pallas_hbm (fused_ar_decode_hbm's int8 codes)",
            "corpus": "formant-synthesized corpus "
                      "(fcl_taco2_tpu_torch/audio/synthcorpus.py)",
            "n_utts": args.n_utts, "n_test": args.n_test,
            "epochs": args.epochs,
            "model": "teacher of torch_mcd_benchmark.py "
                     f"(dunits {cfg.dunits})",
            "compute_dtype": cfg.compute_dtype,
            "quantize_input": "weights cast to compute_dtype first, "
                              "matching the serving order; the "
                              "dequantized decode adds one bf16 rounding "
                              "of codes*scale the kernel does not have",
            "device": device_info(args.device),
        },
        "weight_snr_db": snr,
        "teacher_stage_wall_sec": teacher_stage_sec
        and round(teacher_stage_sec, 1),
        "vs_ground_truth": results,
        "int8_vs_fp32_direct": vs_fp32,
        "int8_kernel_vs_fp32_direct": kernel_vs_fp32,
        "int8_kernel_vs_int8_direct": kernel_vs_deq,
        "total_wall_sec": round(time.time() - t0, 1),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps({"weight_snr_db": snr, "int8_vs_fp32_direct": vs_fp32,
                      "int8_kernel_vs_fp32_direct": kernel_vs_fp32},
                     indent=2))
    for dur_tag in ("pred_dur", "gt_dur"):
        a = results[f"fp32_{dur_tag}"]["mcd"]
        b = results[f"int8_{dur_tag}"]["mcd"]
        c = results[f"int8_kernel_{dur_tag}"]["mcd"]
        print(f"MCD vs ground truth ({dur_tag}): fp32 {a:.3f} dB, int8 "
              f"dequantized {b:.3f} dB ({b - a:+.4f}), int8 kernel "
              f"{c:.3f} dB ({c - a:+.4f})")
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
