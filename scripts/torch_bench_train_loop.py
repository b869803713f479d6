#!/usr/bin/env python3
"""The real training loop on one NVIDIA GPU (scripts/bench_train_loop.py's
protocol, the port's ``Trainer``): its in-loop step time against the
graphed step alone on a real batch of the same shapes, and the host <->
card link.

    python3 scripts/torch_bench_train_loop.py [--epochs 6] [--n-utts 480]
        [--n-val 40] [--n-test 40] [--batch-size 16] [--seed 137]
        [--workdir DIR] [--smoke] [--out results/TORCH_TRAIN_loop.json]

The synthetic corpus (``audio/synthcorpus.py::generate_corpus``, seed 7),
preprocessed on the card (``fcl_preprocess``), trains FCL-taco2-T with
``fcl_train``'s defaults (bf16, duration classes, the device cache and
chains of 4 graph replays a dispatch, evaluation and a snapshot every
epoch).  From the trainer's per-epoch records (``Trainer.loop_stats``,
``log.jsonl``): the steady state's in-loop ms a step (epochs after the
first), dispatch / report fetch / loader wait / the rest, eval,
checkpoint and plot seconds an epoch, the first epoch's capture.  Then
the step alone: chains of 20 replays of the train step's graph on one
batch the trainer's loader made, synchronized host clock.  The link:
pinned host -> card and card -> pinned host copies of 64 MiB, GB/s.
``--workdir`` defaults to a temporary directory.  Needs the card: without
one it raises.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402


def probe_link(size_mib=64, reps=10):
    """Pinned host -> card and card -> pinned host copies of ``size_mib``:
    GB/s of each reading (CUDA events around one copy)."""
    n = size_mib * 2 ** 20 // 4
    host = torch.randn(n).pin_memory()
    dev = torch.empty(n, device="cuda")
    back = torch.empty(n).pin_memory()
    rows = {}
    for name, copy in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                       ("d2h", lambda: back.copy_(dev, non_blocking=True))):
        copy()
        ms = timing.Readings()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            copy()
            end.record()
            end.synchronize()
            ms.add(start.elapsed_time(end))
        rows[f"{name}_gb_s"] = timing.spread(
            [n * 4 / (m / 1e3) / 1e9 for m in ms])
        rows[f"{name}_ms"] = timing.spread(ms)
    if not torch.equal(host, back):
        raise RuntimeError("link probe: the copies changed the data")
    return {"name": "link_probe", "size_mib": size_mib, **rows,
            "card": timing.card()["smi"]}


def make_corpus(workdir, n_utts, n_val, n_test):
    """The synthetic corpus and its features (kept when present)."""
    from fcl_taco2_tpu_torch.audio.synthcorpus import generate_corpus
    from fcl_taco2_tpu_torch.cli import fcl_preprocess
    corpus = os.path.join(workdir, "corpus")
    feat = os.path.join(workdir, "features")
    if not os.path.exists(os.path.join(feat, "train_data.json")):
        generate_corpus(corpus, n_utts=n_utts, seed=7)
        fcl_preprocess.main([
            "--data-root", corpus, "--feature-root", feat,
            "--textgrid-root", os.path.join(corpus, "tg"),
            "--n-val", str(n_val), "--n-test", str(n_test), "--seed", "1"],
            log=lambda *a: None)
    return feat


def device_step_ms(trainer, ts, batch, reps=5, n=20):
    """Chains of ``n`` replays of the train step's graph on ``batch``,
    ``reps`` readings: ms a step."""
    from fcl_taco2_tpu_torch.train.step import make_chained_train_step
    chain = make_chained_train_step(trainer.tx)
    items = [batch] * n
    state = [ts]

    def run():
        state[0], _ = chain(state[0], items, trainer.tcfg.seed)
    run()  # capture
    return timing.interleaved_ms({"s": run}, reps)["s"].scaled(1 / n)


def train_loop_run(workdir, n_utts=480, n_val=40, n_test=40, epochs=6,
                   batch_size=16, seed=137, reps=5):
    """Train, summarize the trainer's epochs, time the step alone."""
    from fcl_taco2_tpu_torch.cli.fcl_train import (get_parser,
                                                   infer_idim_odim,
                                                   model_config_from_args,
                                                   train_config_from_args)
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.loop import Trainer
    from fcl_taco2_tpu_torch.utils.cliconf import parse_with_configs
    t0 = time.perf_counter()
    feat = make_corpus(workdir, n_utts, n_val, n_test)
    corpus_s = time.perf_counter() - t0
    args = parse_with_configs(get_parser(), [
        "--train-json", os.path.join(feat, "train_data.json"),
        "--valid-json", os.path.join(feat, "val_data.json"),
        "--outdir", os.path.join(workdir, "exp_teacher"),
        "--perform-KD", "False", "--epochs", str(epochs),
        "--batch-size", str(batch_size), "--seed", str(seed)])
    args.remat_decoder = False  # fcl_train's default for plain training
    idim, odim = infer_idim_odim(args.valid_json)
    model = Tacotron2SA(model_config_from_args(args, idim, odim),
                        seed=args.seed)
    tcfg = train_config_from_args(args)
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, load_manifest(args.train_json),
                      load_manifest(args.valid_json))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = trainer.run()
    train_s = time.perf_counter() - t0

    stats = trainer.loop_stats
    steady = stats[1:] if len(stats) > 1 else stats
    steps = sum(e["steps"] for e in steady)

    def tot(key):
        return sum(e.get(key, 0.0) for e in steady)

    in_loop = [e["train_wall_s"] / e["steps"] * 1e3 for e in steady]
    with open(os.path.join(tcfg.exp_dir, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    batch = next(iter(trainer._loader(trainer._epoch_batches(0)[:1])))
    dev_ms = device_step_ms(trainer, ts, batch, reps)
    steady_summary = {
        "epochs": len(steady), "steps": steps,
        "in_loop_step_ms": timing.spread(in_loop),
        "timer_step_ms_p50": [e.get("step_ms_p50") for e in log[1:]],
        "per_step_ms": {
            "dispatch": tot("dispatch_s") / steps * 1e3,
            "report_fetch": tot("fetch_s") / steps * 1e3,
            "loader_wait": tot("loader_wait_s") / steps * 1e3,
            "rest": max(0.0, tot("train_wall_s") - tot("dispatch_s")
                        - tot("fetch_s") - tot("loader_wait_s"))
            / steps * 1e3},
        "per_epoch_s": {k: tot(f"{k}_s") / len(steady)
                        for k in ("train_wall", "eval", "ckpt", "plot")},
        "epoch_wall_s": timing.spread(
            [e["train_wall_s"] + e["eval_s"] + e["ckpt_s"] + e["plot_s"]
             for e in steady])}
    in_loop_ms = float(np.median(in_loop))
    return {
        "name": "train_loop", "card": timing.card()["smi"],
        "corpus_and_features_s": corpus_s, "trainer_setup_s": setup_s,
        "train_wall_s": train_s,
        "first_epoch": {"wall_s": stats[0]["train_wall_s"],
                        "first_iter_s": stats[0]["first_iter_s"],
                        "capture_s": stats[0]["capture_s"]},
        "steady_state": steady_summary,
        "device_step_ms": timing.spread(dev_ms),
        "in_loop_over_device_step": in_loop_ms / float(np.median(dev_ms)),
        "batch_shape": {"B": int(batch.tokens.shape[0]),
                        "Tmax": int(batch.tokens.shape[1]),
                        "Lmax": int(batch.mel.shape[1])},
        "loss_last": log[-1].get("main/loss"),
        "epochs_detail": stats}


def smoke(seed=137):
    """A 24-utterance corpus, one epoch, one reading of the step alone."""
    with tempfile.TemporaryDirectory() as wd:
        row = train_loop_run(wd, n_utts=24, n_val=4, n_test=4, epochs=2,
                             batch_size=8, seed=seed, reps=1)
    return [probe_link(16, 2), row]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--n-utts", type=int, default=480)
    p.add_argument("--n-val", type=int, default=40)
    p.add_argument("--n-test", type=int, default=40)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO, "results",
                                                 "TORCH_TRAIN_loop.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    link = probe_link()
    with tempfile.TemporaryDirectory() as tmp:
        row = train_loop_run(args.workdir or tmp, args.n_utts, args.n_val,
                             args.n_test, args.epochs, args.batch_size,
                             args.seed, args.reps)
    payload = {
        "card": timing.card(), "seed": args.seed,
        "protocol": {
            "corpus": f"{args.n_utts} synthetic utterances (seed 7), "
                      f"{args.n_val}/{args.n_test} held out, features "
                      "from fcl_preprocess on the card",
            "model": "FCL-taco2-T, fcl_train defaults (bf16, duration "
                     "classes, device cache, chains of 4 graph replays)",
            "epochs": args.epochs, "batch_size": args.batch_size,
            "timing": "the trainer's own perf_counter records "
                      "(Trainer.loop_stats); the step alone as chains of "
                      "20 graph replays on a batch from the trainer's "
                      "loader, synchronized host clock"},
        "link_probe": link, "rows": [link, row]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"card": timing.card(), "seed": args.seed,
                      **{k: v for k, v in row.items()
                         if k != "epochs_detail"}}))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
