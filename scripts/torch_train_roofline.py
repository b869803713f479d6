#!/usr/bin/env python3
"""The training step's roofline on one NVIDIA GPU
(scripts/train_roofline.py's analytic model at H100 peaks, measured
against the port's graphed teacher step): what could a fused LSTM cell
for the training decoder save?

    python3 scripts/torch_train_roofline.py [--reps 5] [--seed 0]
        [--smoke] [--out results/TORCH_DECODER_bench.json]

For B = 16 and 64 (the bench batch protocol, duration classes 8, 16, 32,
50, FCL-taco2-T in bf16):

- the analytic traffic model of the decoder scans (``class_shapes``,
  ``analytic_model``: strategy A, per-step weight-gradient accumulation
  in memory; B, one weight-gradient GEMM after the scan; C, the tensor
  cores' floor), evaluated at the H100's 989 TFLOP/s bf16 and 3.35 TB/s
  (its 50 MB L2 beside);
- measured: ms of the train step (chains of ``N_TIMED`` graph replays,
  as ``torch_bench.py`` times it) alone, then in turns with its loss
  forward (a CUDA graph), and the backward + update they imply; the
  host's ms a step to enqueue a chain (``timing.enqueue_ms``); the
  step's FLOPs counted by ``FlopCounterMode`` over one eager step; one
  replay's device time from a ``torch.profiler`` trace split by kernel
  class (elementwise, GEMM, other) and its top kernels; a chain of three
  replays traced on the device alone: its span, busy and idle ms a step
  and its longest idle gaps; one eager step's
  device time split by the ``record_function`` ranges of the hand-built
  scan (``ops/rnn_vjp.py::SCAN_RANGES``: its forward and its backward)
  and by class; peak memory.

The verdict: the elementwise device ms inside the scan's ranges is an
upper bound on what a fused cell saves (the fused cell's own time taken
as zero); the eager step's busy time less that is the floor of the step
with it; the scan's measured device ms beside the analytic strategy B.
It goes under ``train_kernel_roofline`` in ``--out``, whose other keys
are kept.  Needs the card: without one it raises.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.ops.rnn_vjp import SCAN_RANGES  # noqa: E402
from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import (  # noqa: E402
    DURATION_CLASSES, MEAN_DUR, N_PHONES, N_TIMED, teacher, train_batch,
    train_step_flops, write)

H100_PEAK_BF16 = timing.PEAK_OPS[torch.bfloat16]
CHAIN_TRACED = 3  # steps of the chain traced device-only for its idle gaps
H100_HBM_BYTES_PER_S = timing.HBM_BYTES_PER_S


def class_shapes(B, classes):
    """The classed plan's (P_c, D_c) shapes for the bench batch."""
    from fcl_taco2_tpu_torch.ops.regroup import (build_classed_plan,
                                                 duration_class_caps)
    rng = np.random.default_rng(0)
    durations = np.clip(rng.poisson(MEAN_DUR, (B, N_PHONES)), 1, 50).astype(
        np.int32)
    olens = durations.sum(1).astype(np.int32)
    Lmax = int(np.ceil(olens.max() / 64) * 64)
    caps = duration_class_caps(list(durations), classes, B, cap_bucket=64)
    plan = build_classed_plan(durations, olens, classes, caps, Lmax)
    return [(int(c.seg_utt.shape[0]), int(c.position.shape[1]))
            for c in plan.classes], int(olens.sum())


def analytic_model(shapes, H=1024, units=256, odim=80, wdt=2):
    """Bytes/flops of the decoder scans fwd+bwd per strategy.

    Per scan step (class with P rows): 3 recurrent GEMMs (P,H)x(H,4H)
    [wh0, wx1, wh1] + the prenet-gate GEMM (P,units)x(units,4H); weights
    read once per step (25 MB bf16 at H=1024); per-step state/save
    traffic in fp32 (4 bytes)."""
    W3 = 3 * H * 4 * H * wdt            # recurrent weights per step
    Wpre = units * 4 * H * wdt
    rows = []
    tot = {"flops_fwd": 0.0, "A_bytes": 0.0, "B_bytes": 0.0}
    for P, D in shapes:
        gemm_flops = 2 * P * (3 * H + units) * 4 * H      # per step fwd
        fwd_state = P * (2 * H + 2 * H) * 4               # h0,h1 saves + c rw
        fwd = D * (W3 + Wpre + fwd_state + P * 4 * H * 4)  # + gates write
        # backward strategy A: weights again + saved reads + dgates +
        # per-step dW accumulator read+write (fp32)
        dW_acc = 2 * (3 * H * 4 * H + units * 4 * H) * 4
        bwd_A = D * (W3 + Wpre + fwd_state + P * 4 * H * 4 + dW_acc)
        # strategy B: sequential part only moves weights + dh/dgates;
        # dW = one GEMM over the saved (P*D) rows at the end
        bwd_B = D * (W3 + Wpre + fwd_state + P * 4 * H * 4) \
            + 2 * P * D * (H + 4 * H) * 4
        tot["flops_fwd"] += D * gemm_flops
        tot["A_bytes"] += fwd + bwd_A
        tot["B_bytes"] += fwd + bwd_B
        rows.append({"P": P, "D": D,
                     "fwd_GB": round(fwd / 1e9, 3),
                     "bwd_A_GB": round(bwd_A / 1e9, 3),
                     "bwd_B_GB": round(bwd_B / 1e9, 3)})
    # fwd+bwd flops ~= 3x fwd (bwd has ~2x the GEMM work)
    tot["flops_total"] = 3 * tot["flops_fwd"]
    return rows, tot


def _classes(events):
    """{class: {"ms", "count"}} of device events."""
    return {k: {"ms": ms, "count": n}
            for k, (ms, n) in timing.top_kernels(events)[1].items()}


def measure(B, classes, reps, n_steps=N_TIMED, seed=0):
    """The graphed teacher step alone and in turns with its loss forward
    at B, FLOPs, the device split of one replay and of one eager step by
    the scan's ranges, peak memory."""
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_chained_train_step,
                                                make_train_step,
                                                step_generator)
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    torch.cuda.reset_peak_memory_stats()
    model = teacher(duration_classes=classes)
    tx = build_optimizer()
    batch, olens = train_batch(B, model.cfg.effective_duration_classes,
                               "cuda", seed)
    eager_model = teacher(duration_classes=classes)
    flops = train_step_flops(eager_model, tx, batch, seed)  # warms it up
    eager_ts = [TrainState(eager_model,
                           tx.init(list(eager_model.parameters())), 0)]
    eager_step = make_train_step(tx, graphed=False)

    def one_eager():
        eager_ts[0], _ = eager_step(eager_ts[0], batch,
                                    step_generator(seed, 1, "cuda"))
    by_range = timing.range_events(one_eager, SCAN_RANGES)
    eager_all = [e for v in by_range.values() for e in v]
    if not all(by_range[name] for name in SCAN_RANGES):
        raise RuntimeError(
            f"roofline B={B}: the trace attributes no device event to "
            f"{[n for n in SCAN_RANGES if not by_range[n]]} "
            f"({len(eager_all)} device events in all)")

    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    chain = make_chained_train_step(tx)
    items = [batch] * n_steps
    state = [ts]

    def steps():
        state[0], _ = chain(state[0], items, seed)

    def loss_fwd(b, gen):
        with torch.no_grad():
            return model.loss_fn(b, gen)[0]

    fwd_graph = Graphed(loss_fwd, "cuda", "roofline.loss_fwd")
    gen = step_generator(seed, 0, "cuda")
    alone = timing.interleaved_ms({"step": steps}, reps)["step"]
    enqueue = timing.enqueue_ms(steps)
    per = timing.interleaved_ms(
        {"step": steps, "loss_fwd": lambda: [fwd_graph(None, batch, gen)
                                             for _ in range(n_steps)]},
        reps)
    step_ms = per["step"].scaled(1 / n_steps)
    fwd_ms = per["loss_fwd"].scaled(1 / n_steps)
    events = timing.device_events(lambda: chain(state[0], items[:1], seed))
    top, _ = timing.top_kernels(events)
    traced = items[:CHAIN_TRACED]
    chained = timing.device_events(lambda: chain(state[0], traced, seed),
                                   host=False)
    idle, gaps = timing.idle_gaps(chained)
    span = (max(e[2] for e in chained) - min(e[1] for e in chained)) / 1e6
    step_med = float(np.median(step_ms))
    return {
        "B": B, "frames": int(olens.sum()), "steps_a_reading": n_steps,
        "step_alone_ms": timing.spread(alone.scaled(1 / n_steps)),
        "host_enqueue_ms_a_step": timing.spread(enqueue.scaled(1 / n_steps)),
        "step_ms": timing.spread(step_ms),
        "loss_fwd_ms": timing.spread(fwd_ms),
        "implied_bwd_update_ms": step_med - float(np.median(fwd_ms)),
        "flops": flops,
        "mfu_h100_bf16": flops / (step_med / 1e3) / H100_PEAK_BF16,
        "device_busy_ms_one_replay": timing.busy_ms(events),
        "kernel_classes_ms": _classes(events),
        "chain_traced": {
            "steps": len(traced), "span_ms_a_step": span / len(traced),
            "busy_ms_a_step": timing.busy_ms(chained) / len(traced),
            "idle_ms_a_step": idle / len(traced),
            "longest_gaps": [{"ms": ms, "after": a, "before": b}
                             for ms, a, b in gaps]},
        "top_kernels": [{"label": lab, "ms": ms, "count": n}
                        for lab, ms, n in top],
        "eager_step": {
            "device_busy_ms": timing.busy_ms(eager_all),
            "kernel_classes_ms": _classes(eager_all),
            "by_range": {name or "outside_scan": _classes(ev)
                         for name, ev in by_range.items()}},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": timing.card()["smi"]}


def verdict(section):
    """What a fused LSTM cell could save, from one eager step's trace:
    the elementwise ms inside the scan's ranges (an upper bound: the
    fused cell's own time taken as zero), the step's busy time less that
    (its floor with the cell), and the scan's device ms against the
    analytic strategy B."""
    out = {}
    for key, sec in section.items():
        if not key.startswith("b"):
            continue
        eager = sec["measured"]["eager_step"]
        busy = eager["device_busy_ms"]
        scan = [eager["by_range"][name] for name in SCAN_RANGES]
        elem = sum(r.get("elementwise", {"ms": 0.0})["ms"] for r in scan)
        scan_ms = sum(c["ms"] for r in scan for c in r.values())
        analytic = sec["analytic_decoder"]
        out[key] = {
            "eager_step_busy_ms": busy,
            "scan_device_ms": scan_ms,
            "scan_elementwise_ms": elem,
            "fused_cell_saves_at_most_ms": elem,
            "fused_cell_saves_at_most_share": elem / busy,
            "step_busy_floor_with_fused_cell_ms": busy - elem,
            "scan_strategy_B_ms": analytic["strategy_B_ms"],
            "scan_over_strategy_B": scan_ms / analytic["strategy_B_ms"]}
    return out


def roofline_section(reps, batches=(16, 64), seed=0, n_steps=N_TIMED):
    """The analytic model and the measurement for each B."""
    classes = DURATION_CLASSES
    c = timing.card()
    section = {"protocol": {
        "what": "teacher train step roofline, duration-classed scans "
                "(the fcl_train default), bf16; chains of N_TIMED graph "
                "replays (synchronized host clock), alone and in turns "
                "with the loss forward; one eager step's device time by "
                "the scan's record_function ranges; analytic decoder "
                "traffic per "
                "backward strategy (A: per-step dW accumulation in memory; "
                "B: one post-scan dW GEMM; C: tensor-core floor)",
        "hw": f"H100: {H100_PEAK_BF16 / 1e12:g} TF/s bf16, "
              f"{H100_HBM_BYTES_PER_S / 1e12:g} TB/s, "
              f"{timing.L2_BYTES // 2 ** 20} MB L2; this card: {c['smi']}",
        "flops": "FlopCounterMode over one eager step (GEMMs and "
                 "convolutions; elementwise ops count 0)"}}
    for B in batches:
        shapes, frames = class_shapes(B, classes)
        rows, tot = analytic_model(shapes)
        meas = measure(B, classes, reps, n_steps, seed)
        section[f"b{B}"] = {
            "class_shapes": shapes, "measured": meas,
            "analytic_decoder": {
                "per_class": rows,
                "strategy_A_ms": tot["A_bytes"] / H100_HBM_BYTES_PER_S * 1e3,
                "strategy_B_ms": tot["B_bytes"] / H100_HBM_BYTES_PER_S * 1e3,
                "tensor_core_floor_ms": tot["flops_total"] / H100_PEAK_BF16
                * 1e3,
                "decoder_flops_fwd_bwd": tot["flops_total"]}}
    section["verdict"] = verdict(section)
    return section


def smoke(seed=0):
    """B = 16, one reading of a chain of two steps."""
    sec = roofline_section(1, (16,), seed, n_steps=2)
    return [dict(sec["b16"]["measured"], name="roofline_b16")]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
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
    section = roofline_section(args.reps, seed=args.seed)
    section["card"], section["seed"] = timing.card(), args.seed
    write(args.out, train_kernel_roofline=section)
    print(json.dumps({"card": timing.card(), "seed": args.seed,
                      "verdict": section["verdict"]}))
    print(f"updated {args.out}")


if __name__ == "__main__":
    main()
