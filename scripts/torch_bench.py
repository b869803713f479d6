#!/usr/bin/env python3
"""The port's headline benchmark on one NVIDIA GPU: batch-1 mel synthesis
speed (frames/s) and the serving and training rows beside it, with the
JAX package's protocol (bench.py), through the port's graphed entry
points (``Synthesizer``, ``TTSPipeline``, the chained ``TrainStep``).

    python3 scripts/torch_bench.py [--reps 5] [--seed 0] [--train-scaling]
                                   [--smoke] [--out results/TORCH_BENCH.json]

Protocol (``utils/bench_protocol.py``): 96 phonemes, Poisson(8)
durations clipped to 1..50, durations given, idim 70, odim 80, frame
budget 1024 (batch 1), seeded weights, bf16 compute; the train batch is
16 utterances of 96 phonemes with the duration classes (8, 16, 32, 50)
of the CLI default (and one single-class row).  Rows:

- the teacher batch-1 family, timed in turns: ragged bf16 (the headline),
  capped (``ragged_decode=False``) and int8;
- the student at batch 1;
- batch-16 synthesis with ``decoder_backend`` auto, scan, hybrid and
  hybrid + int8, timed in turns;
- text -> wav at batch 16 (the student and PWG v1), x realtime;
- the teacher train step (chains of graph replays), frames/s and MFU
  against the H100's 989 TFLOP/s bf16, its FLOPs counted by
  ``FlopCounterMode`` over one eager step (forward, the hand-built
  decoder backward and the update);
- with ``--train-scaling`` the classed step at B = 32 and 64.

Each reading is the synchronized host clock around ``N_TIMED`` calls
(serving: ``synth_batch`` / ``tts_batch``, each ending in its copy to the
host; training: one chain of steps), after the capture and a warm-up;
each row gives the median, min, max and count of ``--reps`` readings.
``vs_baseline`` divides the headline by the reference-style decode (a
per-frame Python loop over ``nn.LSTMCell``, bench.py:114-212) timed on the
same card in the same run.

Prints one JSON line ``{"metric": "batch1_synthesis_mel_frames_per_sec",
...}`` with every row under ``extra`` and writes ``--out``.  Needs the
card: without one it raises.
"""

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import (  # noqa: E402
    DURATION_CLASSES, FRAME_BUDGET, IDIM, MAX_DUR, MEAN_DUR, N_PHONES,
    N_TIMED, ODIM, TRAIN_B, batch_inputs, make_inputs, rate_row, student,
    teacher, train_batch, train_step_flops)

def reference_decode_run(reps, seed=0):
    """bench.py:114-212's reference-style decode on the card: the teacher's
    shapes as plain modules, a Python loop over frames with two
    ``nn.LSTMCell``s, batch = one utterance's phonemes; one reading a
    decode."""
    import torch.nn.functional as F
    from torch import nn
    dev = "cuda"
    torch.manual_seed(seed)
    eunits, dunits, prenet_units = 512, 1024, 256
    embed = nn.Embedding(IDIM, 512, padding_idx=0)
    convs = nn.ModuleList([nn.Sequential(
        nn.Conv1d(512, 512, 5, padding=2, bias=False), nn.BatchNorm1d(512),
        nn.ReLU()) for _ in range(3)])
    blstm = nn.LSTM(512, eunits // 2, batch_first=True, bidirectional=True)
    pitch_pred = nn.Sequential(nn.Conv1d(512, 384, 3, padding=1), nn.ReLU(),
                               nn.Conv1d(384, 1, 1))
    energy_pred = nn.Sequential(nn.Conv1d(512, 384, 3, padding=1),
                                nn.ReLU(), nn.Conv1d(384, 1, 1))
    pitch_embed = nn.Conv1d(1, eunits, 9, padding=4)
    energy_embed = nn.Conv1d(1, eunits, 9, padding=4)
    prenet = nn.ModuleList([nn.Linear(ODIM, prenet_units),
                            nn.Linear(prenet_units, prenet_units)])
    lstm0 = nn.LSTMCell(eunits + prenet_units + 1, dunits)
    lstm1 = nn.LSTMCell(dunits, dunits)
    feat_out = nn.Linear(eunits + dunits, ODIM, bias=False)
    postnet = nn.ModuleList([nn.Sequential(nn.Conv1d(
        ODIM if i == 0 else 512, ODIM if i == 4 else 512, 5, padding=2,
        bias=False), nn.BatchNorm1d(ODIM if i == 4 else 512))
        for i in range(5)])
    nn.ModuleList([embed, convs, blstm, pitch_pred, energy_pred,
                   pitch_embed, energy_embed, prenet, lstm0, lstm1, feat_out,
                   postnet]).to(dev).eval()  # moved in place
    tokens_np, dur_np = make_inputs(seed)
    tokens = torch.from_numpy(tokens_np.astype(np.int64)).to(dev)
    dur = torch.from_numpy(dur_np.astype(np.int64))

    @torch.no_grad()
    def decode_once():
        x = embed(tokens.unsqueeze(0)).transpose(1, 2)
        for c in convs:
            x = c(x)
        h, _ = blstm(x.transpose(1, 2))
        h = h.squeeze(0)
        p = pitch_pred(h.T.unsqueeze(0))
        e = energy_pred(h.T.unsqueeze(0))
        h = h + pitch_embed(p).squeeze(0).T + energy_embed(e).squeeze(0).T
        P = h.shape[0]
        max_d = int(dur.max())
        pos = torch.zeros(P, max_d)
        for i in range(P):
            d = int(dur[i])
            pos[i, :d] = torch.arange(d) / d
        pos = pos.to(dev)
        z0, c0, z1, c1 = (torch.zeros(P, dunits, device=dev)
                          for _ in range(4))
        prev = torch.zeros(P, ODIM, device=dev)
        outs = []
        for t in range(max_d):  # the reference's hot Python loop
            pn = prev
            for lin in prenet:
                pn = F.dropout(torch.relu(lin(pn)), 0.5, training=True)
            xt = torch.cat([h, pn, pos[:, t:t + 1]], dim=1)
            z0, c0 = lstm0(xt, (z0, c0))
            z1, c1 = lstm1(z0, (z1, c1))
            out = feat_out(torch.cat([z1, h], dim=1))
            outs.append(out)
            prev = out
        seg = torch.stack(outs, dim=1)
        mel = torch.cat([seg[i, :int(dur[i])] for i in range(P)], 0)
        m = mel.T.unsqueeze(0)
        for i, pc in enumerate(postnet):
            m = pc(m)
            if i < 4:
                m = torch.tanh(m)
        return (mel + m.squeeze(0).T).cpu()

    frames = int(dur.sum())
    ms = timing.interleaved_ms({"ref": decode_once}, reps)["ref"]
    return rate_row("reference_loop_batch1_frames_per_sec", ms, frames,
                    "frames_per_sec", frames=frames,
                    what="bench.py:114-212's loop, eager, on the card")


def _synth_calls(synths, toks, durs):
    """{tag: one synth_batch call with a fresh seed}; each bucket's graph
    captured by a first call."""
    calls = {}
    for tag, synth in synths.items():
        nxt = itertools.count(1).__next__  # a fresh seed a call
        synth.synth_batch(toks, 0, durations=durs)
        calls[tag] = (lambda s=synth, n=nxt:
                      s.synth_batch(toks, n(), durations=durs))
    return calls


def batch1_family_run(reps, n_iters=N_TIMED, seed=0):
    """The teacher at batch 1, timed in turns: ragged bf16 (the headline),
    capped (``ragged_decode=False``) and int8 (bench.py:273-332)."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    model = teacher()
    tok, dur = make_inputs(seed)
    synths = {
        "batch1_synthesis_mel_frames_per_sec": Synthesizer(model, 1),
        "batch1_synth_capped_frames_per_sec": Synthesizer(
            model, 1, ragged_decode=False),
        "batch1_synth_int8_frames_per_sec": Synthesizer(
            model, 1, quantize="int8"),
    }
    per = timing.interleaved_ms(_synth_calls(synths, [tok], [dur]), reps,
                                n_iters)
    frames = int(dur.sum())
    return [rate_row(tag, ms, frames, "frames_per_sec", frames=frames,
                     batch=1, model="FCL-taco2-T bf16")
            for tag, ms in per.items()]


def student_batch1_run(reps, n_iters=N_TIMED, seed=0):
    """The student at batch 1 (bench.py:529): ``fused_ar_decode``."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    tok, dur = make_inputs(seed)
    synth = Synthesizer(student(), 1)
    tag = "student_batch1_synth_frames_per_sec"
    per = timing.interleaved_ms(_synth_calls({tag: synth}, [tok], [dur]),
                                reps, n_iters)
    frames = int(dur.sum())
    return [rate_row(tag, per[tag], frames, "frames_per_sec", frames=frames,
                     batch=1, model="FCL-taco2-S bf16")]


def batched_synth_run(reps, n_iters=10, seed=0):
    """B = 16 in one call, ``decoder_backend`` auto, scan, hybrid and
    hybrid + int8, timed in turns (bench.py:454)."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    model = teacher()
    toks, durs = batch_inputs(TRAIN_B, seed)
    synths = {}
    for tag, backend in (
            ("batch16_synth_frames_per_sec", "auto"),
            ("batch16_synth_scan_frames_per_sec", "scan"),
            ("batch16_synth_hybrid_frames_per_sec", "hybrid"),
            ("batch16_synth_hybrid_int8_frames_per_sec", "hybrid+int8")):
        backend, _, q = backend.partition("+")
        synths[tag] = Synthesizer(model, TRAIN_B, decoder_backend=backend,
                                  quantize=q or "none")
    per = timing.interleaved_ms(_synth_calls(synths, toks, durs), reps,
                                n_iters)
    frames = int(sum(d.sum() for d in durs))
    return [rate_row(tag, ms, frames, "frames_per_sec", frames=frames,
                     batch=TRAIN_B, model="FCL-taco2-T bf16")
            for tag, ms in per.items()]


def e2e_tts_run(reps, n_iters=5, seed=0):
    """Text -> wav at B = 16 (bench.py:568): the student and PWG v1
    through ``TTSPipeline.tts_batch`` (one graph: decode, the noise draw
    and ``pwg_generate_streaming``), the frame budget 1024; x realtime =
    audio seconds over wall seconds."""
    from fcl_taco2_tpu_torch.infer import TTSPipeline
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    pwg_cfg = PWGConfig()
    pipe = TTSPipeline(student(), ParallelWaveGAN(pwg_cfg, seed=1))
    toks, durs = batch_inputs(TRAIN_B, seed)
    fpt = FRAME_BUDGET // N_PHONES  # tts_batch's budget: FRAME_BUDGET
    nxt = itertools.count(1).__next__  # a fresh seed a call
    _, stats = pipe.tts_batch(toks, 0, frame_per_token=fpt, durations=durs)
    tag = "e2e_tts_batch16_x_realtime"
    per = timing.interleaved_ms({tag: lambda: pipe.tts_batch(
        toks, nxt(), frame_per_token=fpt, durations=durs)}, reps, n_iters)
    audio_s = stats["audio_sec"]
    return [rate_row(tag, per[tag], audio_s, "x_realtime", audio_s=audio_s,
                     batch=TRAIN_B, frame_budget=FRAME_BUDGET,
                     samples_vocoded=TRAIN_B * FRAME_BUDGET * pwg_cfg.hop,
                     model="FCL-taco2-S bf16 + PWG v1 (bf16-rounded)")]


def train_step_run(reps, n_steps=N_TIMED, B=TRAIN_B,
                   duration_classes=DURATION_CLASSES, suffix="", seed=0):
    """The teacher train step at bf16 (bench.py:383-452): ms a step from
    chains of ``n_steps`` replays of the step's CUDA graph (the trainer's
    path), frames/s, FLOPs of one step and MFU against 989 TFLOP/s."""
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import make_chained_train_step
    model = teacher(duration_classes=duration_classes)
    tx = build_optimizer()
    batch, olens = train_batch(B, model.cfg.effective_duration_classes,
                               "cuda", seed)
    flops = train_step_flops(teacher(duration_classes=duration_classes),
                             tx, batch, seed)
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    chain = make_chained_train_step(tx)
    items = [batch] * n_steps
    losses = []

    def run():
        nonlocal ts
        ts, reports = chain(ts, items, seed)
        losses.append(reports[-1, chain.report_keys.index("loss")])
    run()  # capture
    tag = f"train_step{suffix}"
    ms = timing.interleaved_ms({tag: run}, reps)[tag].scaled(1 / n_steps)
    enqueue = timing.enqueue_ms(run).scaled(1 / n_steps)
    frames = int(olens.sum())
    step_ms = float(np.median(ms))
    peak = timing.PEAK_OPS[torch.bfloat16]
    if not torch.isfinite(torch.stack(losses)).all():
        raise RuntimeError(f"{tag}: non-finite loss")
    row = rate_row(f"train{suffix}_frames_per_sec", ms, frames,
                   "frames_per_sec", frames=frames, batch=B,
                   duration_classes=list(duration_classes),
                   steps_a_reading=n_steps, model="FCL-taco2-T bf16",
                   host_enqueue_ms_a_step=timing.spread(enqueue),
                   capture_s=chain.capture_s)
    row[f"train_step{suffix}_flops"] = flops
    row[f"train{suffix}_mfu_h100_bf16"] = flops / (step_ms / 1e3) / peak
    return [row]


def train_step_single_class_run(reps, n_steps=N_TIMED, seed=0):
    """The single-class reference row for the classed default."""
    return train_step_run(reps, n_steps, duration_classes=(),
                          suffix="_single_class", seed=seed)


def train_scaling_run(reps, n_steps=N_TIMED, seed=0):
    """Classed rows at B = 32 and 64 (bench.py:651-664)."""
    return [row for B in (32, 64)
            for row in train_step_run(reps, n_steps, B=B, suffix=f"_b{B}",
                                      seed=seed)]


def protocol(seed, reps):
    return {"n_phones": N_PHONES, "mean_dur": MEAN_DUR, "max_dur": MAX_DUR,
            "idim": IDIM, "odim": ODIM, "frame_budget": FRAME_BUDGET,
            "train_batch": TRAIN_B,
            "duration_classes": list(DURATION_CLASSES), "seed": seed,
            "reps": reps,
            "timing": "synchronized host clock around N calls after the "
                      "capture and a warm-up (serving: N synth_batch / "
                      "tts_batch calls, each with its copy to the host; "
                      "training: a chain of N graph replays); variant "
                      "families timed in turns"}


def smoke(seed=0):
    """Each measurement once at full width, one reading of one call."""
    rows = [reference_decode_run(1, seed=seed)]
    rows += batch1_family_run(1, 1, seed)
    rows += student_batch1_run(1, 1, seed)
    rows += batched_synth_run(1, 1, seed)
    rows += e2e_tts_run(1, 1, seed)
    rows += train_step_run(1, 2, seed=seed)
    return rows


def headline(rows, reference):
    """The one JSON line: the headline frames/s, ``vs_baseline`` against
    the reference-style loop, every row under ``extra``."""
    by = {r["name"]: r for r in rows}
    fps = by["batch1_synthesis_mel_frames_per_sec"]["frames_per_sec"]
    base = reference["frames_per_sec"]["median"]
    return {"metric": "batch1_synthesis_mel_frames_per_sec",
            "value": fps["median"], "unit": "frames/s",
            "vs_baseline": fps["median"] / base,
            "extra": {"card": timing.card(), "rows": rows,
                      "reference": reference}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-scaling", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="each measurement once, one reading")
    p.add_argument("--out", default=os.path.join(REPO, "results",
                                                 "TORCH_BENCH.json"))
    args = p.parse_args(argv)
    timing.require_card()
    if args.smoke:
        print(json.dumps({"card": timing.card(), "seed": args.seed,
                          "rows": smoke(args.seed)}))
        return
    reference = reference_decode_run(args.reps, seed=args.seed)
    rows = batch1_family_run(args.reps, seed=args.seed)
    for run in (student_batch1_run, batched_synth_run, e2e_tts_run,
                train_step_run, train_step_single_class_run):
        rows += run(args.reps, seed=args.seed)
    if args.train_scaling:
        rows += train_scaling_run(args.reps, seed=args.seed)
    line = headline(rows, reference)
    line["extra"]["protocol"] = protocol(args.seed, args.reps)
    print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=1)


if __name__ == "__main__":
    main()
