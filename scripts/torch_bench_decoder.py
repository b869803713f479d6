#!/usr/bin/env python3
"""The AR decoder loop on one NVIDIA GPU (scripts/bench_pallas.py's
protocol, the port's routes): the plain ``scan`` route against the CUDA
kernels, and the training path's teacher-forced scans.

    python3 scripts/torch_bench_decoder.py [--reps 10] [--seed 0] [--smoke]
        [--out results/TORCH_DECODER_bench.json]

Inference rows (the decoder loop alone, seeded weights, dropout 0.5 as
published, durations Poisson(8) clipped to 1..50 and sorted longest
first, ``max_dur`` = 50 steps bounded per 128-row tile, as ``synthesize``
gives them):

- FCL-taco2-S at P = 96: ``models/decoder.py::decoder_inference`` (the
  ``scan`` route, to its static step count, the steps past the bound
  zeroed) in fp32 and bf16, against ``ops/decoder_cuda.py::
  fused_ar_decode`` (weights fp32 and bf16, ragged; fp32 also capped at
  50 steps);
- FCL-taco2-T at P = 96 and 1536: the scan in fp32 and bf16 against
  ``fused_ar_decode_hbm`` (weights bf16, int8 codes and fp32, ragged;
  bf16 also capped).

Each variant is one CUDA graph (as ``synthesize`` runs it); the variants
of a (model, P) group are timed in turns, each reading ``ITERS``
replays between two synchronizations of the card.  Training rows
(bench_pallas.py:215-268): the teacher-forced decoder of both models on
the bench train batch (B = 16 of 96 phonemes, duration classes 8, 16,
32, 50, bf16 compute), forward and forward + backward (every weight's
gradient consumed), each a CUDA graph.  Writes ``rows`` and
``train_path_rows`` into ``--out`` and keeps the file's other keys
(``train_kernel_roofline`` from ``torch_train_roofline.py``).  Needs the
card: without one it raises.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import (  # noqa: E402
    DURATION_CLASSES, MEAN_DUR, TRAIN_B, student, teacher, train_batch,
    write)

DROPOUT = 0.5
ITERS = 10  # replays a reading


def segments(cfg, P, seed=0):
    """Decoder inputs as ``synthesize`` builds them on the kernel route:
    (enc (P, dec_idim), durations, position, frame_mask, tile bounds,
    step bound), sorted longest first."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    rng = np.random.default_rng(seed)
    dur = np.sort(np.clip(rng.poisson(MEAN_DUR, P), 1,
                          cfg.max_dur).astype(np.int32))[::-1].copy()
    dur_t = torch.from_numpy(dur).cuda()
    d = torch.arange(cfg.max_dur, device="cuda")[None, :]
    fm = d < dur_t[:, None]
    pos = torch.where(fm, d.float() / dur_t[:, None].float(), 0.0)
    enc = torch.from_numpy(
        rng.normal(size=(P, cfg.dec_idim)).astype(np.float32)).cuda()
    return enc, dur_t, pos, fm, K.tile_step_bounds(dur_t), dur_t.max()


def _graph(fn, name, inputs):
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    g = Graphed(fn, "cuda", name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda: g(None, inputs, gen)


def decoder_rows(model_key, P, reps, iters=ITERS, seed=0):
    """One row a route at (model, P), the routes timed in turns."""
    from fcl_taco2_tpu_torch.models.decoder import decoder_inference
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.utils.cuda_build import seed_tensor
    model = (teacher if model_key == "teacher" else student)(
        dropout_rate=DROPOUT)
    cfg = model.cfg
    enc, dur, pos, fm, bounds, step_bound = segments(cfg, P, seed)
    dec32 = model.decoder
    dec16 = copy.deepcopy(dec32).to(torch.bfloat16)
    dp = dec32.jax_layout()
    seed_t = seed_tensor(0, torch.device("cuda"))
    calls = {}
    with torch.no_grad():
        for tag, dec, dt in (("scan_fp32", dec32, torch.float32),
                             ("scan_bf16", dec16, torch.bfloat16)):
            calls[tag] = _graph(
                lambda inp, gen, dec=dec: decoder_inference(
                    dec, cfg, inp[0], None, inp[1], fm, gen,
                    step_bound=step_bound),
                f"bench.{tag}", (enc.to(dt), pos.to(dt)))
        if model_key == "student":
            fn, variants = K.fused_ar_decode, (
                ("fused_fp32", torch.float32, True),
                ("fused_bf16", torch.bfloat16, True),
                ("fused_fp32_capped", torch.float32, False))
        else:
            fn, variants = K.fused_ar_decode_hbm, (
                ("hbm_bf16", torch.bfloat16, True),
                ("hbm_int8", torch.int8, True),
                ("hbm_fp32", torch.float32, True),
                ("hbm_bf16_capped", torch.bfloat16, False))
        for tag, wdt, ragged in variants:
            prequant = K.maybe_prequantize(cfg, dp, "int8") \
                if wdt == torch.int8 else None
            pk = K.pack_decoder_weights(dp, cfg.dec_idim, wdt,
                                        prequant=prequant)
            kw = dict(zoneout=cfg.zoneout_rate, dropout=DROPOUT,
                      weights_dtype=wdt, packed=pk,
                      bounds=bounds if ragged else None)
            calls[tag] = _graph(
                lambda inp, gen, kw=kw: fn(dp, inp[0], inp[1], seed_t, **kw),
                f"bench.{tag}", (enc, pos))
        per = timing.interleaved_ms(calls, reps, iters)
    best_scan = min(np.median(per["scan_fp32"]), np.median(per["scan_bf16"]))
    rows = []
    for tag, ms in per.items():
        rows.append({"name": f"{model_key}_P{P}_{tag}", "model": model_key,
                     "P": P, "route": tag, "ms": timing.spread(ms),
                     "speedup_vs_best_scan": best_scan / np.median(ms),
                     "step_bound": int(step_bound), "D": cfg.max_dur,
                     "card": timing.card()["smi"]})
    return rows


def train_path_row(model_key, reps, iters=ITERS, B=TRAIN_B, seed=0):
    """The teacher-forced decoder (the training path's scans, classed) at
    bf16: forward and forward + backward, each a CUDA graph, in turns."""
    from fcl_taco2_tpu_torch.models.decoder import (
        decoder_teacher_forced_classed)
    model = (teacher if model_key == "teacher" else student)(
        duration_classes=DURATION_CLASSES)
    cfg = model.cfg
    dt = getattr(torch, cfg.compute_dtype)
    dec = copy.deepcopy(model.decoder).to(dt).train()
    batch, _ = train_batch(B, cfg.effective_duration_classes, "cuda",
                              seed)
    rng = np.random.default_rng(seed)
    class_inputs = tuple(
        (torch.from_numpy(rng.normal(size=(sc.seg_utt.shape[0],
                                           cfg.dec_idim))).to("cuda", dt),
         torch.from_numpy(rng.normal(size=tuple(sc.position.shape)
                                     + (cfg.odim,))).to("cuda", dt),
         sc.position.to(dt)) for sc in batch.seg_classes)
    params = list(dec.parameters())

    def fwd(inputs, gen):
        after, before = decoder_teacher_forced_classed(
            dec, cfg, inputs, batch.utt_gather, batch.utt_mask, gen, True,
            bn_out=[])
        return after.float().abs().mean() + before.float().abs().mean()

    def fwd_bwd(inputs, gen):
        grads = torch.autograd.grad(fwd(inputs, gen), params,
                                    allow_unused=True)
        return sum(g.float().sum() for g in grads if g is not None)

    calls = {"tf_scan_fwd": _graph(fwd, "bench.tf_fwd", class_inputs),
             "tf_scan_fwd_bwd": _graph(fwd_bwd, "bench.tf_fwd_bwd",
                                       class_inputs)}
    per = timing.interleaved_ms(calls, reps, iters)
    row = {"name": f"{model_key}_train_path", "model": model_key, "B": B,
           "classes": [[int(c[0].shape[0]), int(c[2].shape[1])]
                       for c in class_inputs],
           **{f"{k}_ms": timing.spread(v) for k, v in per.items()},
           "compute_dtype": cfg.compute_dtype,
           "card": timing.card()["smi"]}
    return row


def smoke(seed=0):
    """Each model at P = 96 and the teacher's training path, one reading
    of one replay."""
    return (decoder_rows("student", 96, 1, 1, seed)
            + decoder_rows("teacher", 96, 1, 1, seed)
            + [train_path_row("teacher", 1, 1, seed=seed)])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO, "results",
                                                 "TORCH_DECODER_bench.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    rows = decoder_rows("student", 96, args.reps, seed=args.seed)
    for P in (96, 1536):
        rows += decoder_rows("teacher", P, args.reps, seed=args.seed)
    train_rows = [train_path_row(m, args.reps, seed=args.seed)
                  for m in ("teacher", "student")]
    write(args.out, card=timing.card(), seed=args.seed, protocol={
        "what": "the decoder loop alone: the scan route against the CUDA "
                "kernels, each a CUDA graph; the routes of a (model, P) "
                f"timed in turns, {args.reps} readings of {ITERS} "
                "replays (synchronized host clock); dropout 0.5, "
                "Poisson(8) durations sorted longest first, 128-row tile "
                "bounds; the training path's teacher-forced scans at "
                "B=16 classed, bf16"}, rows=rows, train_path_rows=train_rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
