#!/usr/bin/env python3
"""The KD train step's cost envelope on one NVIDIA GPU
(scripts/bench_kd.py's protocol, the port's step).

    python3 scripts/torch_bench_kd.py [--reps 5] [--max-b 128] [--seed 0]
                                      [--smoke]
                                      [--out results/TORCH_KD_envelope.json]

The KD step (the frozen FCL-taco2-T's forward with its captures, then
FCL-taco2-S's forward, the hand-built decoder backward and the update)
at the bench batch (96 phonemes an utterance, Poisson(8) durations, seed
0, bf16), as the trainer runs it: chains of replays of the step's CUDA
graph.  For B = 16, 32, 64, 128, with ``remat_decoder`` on and off and
duration classes (8, 16, 32) on and off; each configuration runs in its
own process, so its peak memory (``max_memory_allocated`` after
``reset_peak_memory_stats``, the weights included) is its own, and the
doubling stops at the first configuration that runs out of memory (which
is recorded).  Then the B = 16 breakdown (remat on, the KD default),
each part a CUDA graph timed in turns: the teacher's forward, the whole
KD loss forward (no gradient), forward + backward, and the step with the
update; the student's forward, the backward and the update follow by
difference.  Needs the card: without one it raises.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import (  # noqa: E402
    IDIM, ODIM, rate_row, train_batch)

KD_CLASSES = (8, 16, 32)  # bench_kd.py's classed runs
N_STEPS = 10  # chained KD steps a reading


def _kd(B, remat, classes, seed):
    from fcl_taco2_tpu_torch.models import student_config, teacher_config
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    kw = dict(odim=ODIM, duration_classes=classes, remat_decoder=remat)
    kd = KDStudent(student_config(IDIM, **kw),
                   teacher_config(IDIM, **kw), seed=seed)
    batch, olens = train_batch(
        B, kd.scfg.effective_duration_classes, "cuda", seed)
    return kd, batch, olens


def kd_step_run(B, remat, classes, reps, n_steps=N_STEPS, seed=0):
    """One configuration: ms a KD step from chains of ``n_steps`` graph
    replays, frames/s, peak memory, the first and last loss."""
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import make_chained_train_step
    torch.cuda.reset_peak_memory_stats()
    kd, batch, olens = _kd(B, remat, classes, seed)
    model = kd.student
    tx = build_optimizer()
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    chain = make_chained_train_step(tx, kd.loss_fn)
    items = [batch] * n_steps
    losses = []

    def run():
        nonlocal ts
        ts, reports = chain(ts, items, seed)
        losses.append(float(reports[-1, chain.report_keys.index("loss")]))
    run()  # capture
    ms = timing.interleaved_ms({"kd": run}, reps)["kd"].scaled(1 / n_steps)
    frames = int(olens.sum())
    return rate_row(
        "kd_step", ms, frames, "frames_per_sec", B=B, remat_decoder=remat,
        duration_classes=list(classes), frames=frames,
        segments=sum(int(c.seg_utt.shape[0]) for c in batch.seg_classes)
        if batch.seg_classes else int(batch.seg_utt.shape[0]),
        Lmax=int(batch.mel.shape[1]), steps_a_reading=n_steps,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        capture_s=chain.capture_s, loss_first=losses[0],
        loss_last=losses[-1], loss_finite=bool(np.isfinite(losses).all()))


def kd_breakdown_run(B, classes, reps, n_iters=5, seed=0, remat=True):
    """The KD step at B split into its parts (bench_kd.py:190-272), each a
    CUDA graph, timed in turns: teacher forward (its captures summed),
    the KD loss forward, forward + backward, and the whole step."""
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from torch.utils._pytree import tree_leaves

    from fcl_taco2_tpu_torch.train.step import (loss_and_grads,
                                                make_train_step,
                                                step_generator)
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    kd, batch, olens = _kd(B, remat, classes, seed)
    model = kd.student
    tx = build_optimizer()
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    step = make_train_step(tx, kd.loss_fn)

    def teacher_fwd(b, gen):
        with torch.no_grad():
            _, (_, _, know) = kd.teacher.loss_fn(b, gen, train=True,
                                                 capture_kd=True)
            return sum(v.float().sum() for v in tree_leaves(know))

    def loss_fwd(b, gen):
        with torch.no_grad():
            return kd.loss_fn(b, gen)[0]

    def fwd_bwd(b, gen):
        return loss_and_grads(model, b, gen, kd.loss_fn)[0]["grad_norm"]

    gen = step_generator(seed, 0, "cuda")
    calls = {}
    for name, fn in (("teacher_fwd", teacher_fwd), ("loss_fwd", loss_fwd),
                     ("fwd_bwd", fwd_bwd)):
        g = Graphed(fn, "cuda", f"kd.{name}")
        calls[name] = (lambda g=g: g(None, batch, gen))

    def one_step():
        nonlocal ts
        ts, _ = step(ts, batch, gen)
    calls["step"] = one_step
    per = timing.interleaved_ms(calls, reps, n_iters)
    med = {k: float(np.median(v)) for k, v in per.items()}
    return {"name": "kd_breakdown", "B": B, "remat_decoder": remat,
            "duration_classes": list(classes),
            **{f"{k}_ms": timing.spread(v) for k, v in per.items()},
            "derived_student_fwd_ms": med["loss_fwd"] - med["teacher_fwd"],
            "derived_backward_ms": med["fwd_bwd"] - med["loss_fwd"],
            "derived_update_ms": med["step"] - med["fwd_bwd"],
            "frames": int(olens.sum()), "card": timing.card()["smi"]}


def _classes_arg(text):
    return tuple(int(x) for x in text.split(",")) if text != "-" else ()


def _subprocess_row(args, timeout=1800):
    """Run this script with ``args`` in a fresh process: its row, or
    ``{"status": "OOM", ...}`` where the child ran out of device memory.
    Any other failure raises with the child's output tail."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("ROW ")]
    if r.returncode == 0 and lines:
        return json.loads(lines[-1][4:])
    tail = (r.stdout + r.stderr)[-2000:]
    if any(k in tail for k in ("OutOfMemoryError", "CUDA out of memory",
                                "CUDA error: out of memory")):
        return {"status": "OOM", "detail": tail[-600:]}
    raise RuntimeError(f"{' '.join(args)}: exit code {r.returncode}, "
                       f"no row:\n{tail}")


def envelope_rows(reps, max_b, seed):
    """Every (classes, remat, B) configuration in its own process, B
    doubling from 16 until ``max_b`` or the first out-of-memory."""
    rows = []
    for classes in ("-", ",".join(map(str, KD_CLASSES))):
        for remat in (False, True):
            B = 16
            while B <= max_b:
                row = _subprocess_row(["--one", str(B), str(remat), classes,
                                       "--reps", str(reps), "--seed",
                                       str(seed)])
                row.update(B=B, remat_decoder=remat,
                           duration_classes=list(_classes_arg(classes)))
                rows.append(row)
                print(f"B={B} remat={remat} classes={classes}: "
                      f"{row.get('status', 'done')}", flush=True)
                if "status" in row:
                    break  # out of memory: a larger B does not fit either
                B *= 2
    return rows


def breakdown_rows(reps, seed):
    rows = []
    for classes in ("-", ",".join(map(str, KD_CLASSES))):
        row = _subprocess_row(["--one-breakdown", "16", classes, "--reps",
                               str(reps), "--seed", str(seed)])
        row.setdefault("duration_classes", list(_classes_arg(classes)))
        rows.append(row)
        print(f"breakdown classes={classes}: {row.get('status', 'done')}",
              flush=True)
    return rows


def smoke(seed=0):
    """One configuration and the breakdown, in this process, one reading
    each; remat off (its captures take a third of the time)."""
    return [kd_step_run(16, False, KD_CLASSES, 1, 2, seed),
            kd_breakdown_run(16, KD_CLASSES, 1, 1, seed, remat=False)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--max-b", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--one", nargs=3, metavar=("B", "REMAT", "CLASSES"))
    p.add_argument("--one-breakdown", nargs=2, metavar=("B", "CLASSES"))
    p.add_argument("--out", default=os.path.join(
        REPO, "results", "TORCH_KD_envelope.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.one:
        row = kd_step_run(int(args.one[0]), args.one[1] == "True",
                          _classes_arg(args.one[2]), args.reps,
                          seed=args.seed)
        print("ROW " + json.dumps(row), flush=True)
        return
    if args.one_breakdown:
        row = kd_breakdown_run(int(args.one_breakdown[0]),
                               _classes_arg(args.one_breakdown[1]),
                               args.reps, seed=args.seed)
        print("ROW " + json.dumps(row), flush=True)
        return
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    payload = {
        "card": timing.card(), "seed": args.seed,
        "protocol": {
            "what": "the KD step (teacher forward with captures + student "
                    "forward, hand-built backward, adam update) at 96 "
                    "phonemes an utterance, Poisson(8) durations, bf16; "
                    f"chains of {N_STEPS} CUDA graph replays, "
                    f"{args.reps} readings (synchronized host clock); peak "
                    "memory = max_memory_allocated in a fresh process per "
                    "configuration, weights included",
            "breakdown": "B=16, remat on: teacher forward, KD loss forward "
                         "(no gradient), forward + backward, whole step, "
                         "each a CUDA graph, timed in turns; the student "
                         "forward, backward and update by difference"},
        "rows": envelope_rows(args.reps, args.max_b, args.seed),
        "kd_breakdown_b16": breakdown_rows(args.reps, args.seed),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
