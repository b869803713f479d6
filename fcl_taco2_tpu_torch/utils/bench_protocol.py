"""The bench protocol of the port's measurement scripts
(``scripts/torch_bench*.py``, ``scripts/torch_train_roofline.py``) and of
``chip_smoke.py``: the inputs, the train batch, the seeded models, the
row and results-file formats (the port's own copy of ``bench.py``'s
protocol; the JAX package timed its own).

Protocol: 96 phonemes an utterance, Poisson(8) durations clipped to
1..50, idim 70, odim 80, frame budget 1024 (batch 1); the train batch is
16 utterances of 96 phonemes with the duration classes (8, 16, 32, 50)
of the CLI default.
"""

import json
import os

import numpy as np
import torch

from fcl_taco2_tpu_torch.utils import timing

IDIM, ODIM = 70, 80
N_PHONES = 96          # a realistic LJSpeech utterance (~10 s of speech)
MEAN_DUR, MAX_DUR = 8, 50
FRAME_BUDGET = 1024
N_TIMED = 20            # calls (serving) or chained steps (training) a reading
TRAIN_B = 16            # the teacher's training batch
DURATION_CLASSES = (8, 16, 32, 50)  # the CLI default (--duration-classes)


def make_inputs(seed=0):
    """One utterance: (tokens, durations) int32 of N_PHONES."""
    rng = np.random.default_rng(seed)
    dur = np.clip(rng.poisson(MEAN_DUR, N_PHONES), 1, MAX_DUR).astype(
        np.int32)
    tokens = rng.integers(1, IDIM, N_PHONES).astype(np.int32)
    return tokens, dur


def batch_inputs(B, seed=0):
    """B utterances of N_PHONES: (token lists, duration lists)."""
    rng = np.random.default_rng(seed)
    dur = np.clip(rng.poisson(MEAN_DUR, (B, N_PHONES)), 1, MAX_DUR).astype(
        np.int32)
    tokens = rng.integers(1, IDIM, (B, N_PHONES)).astype(np.int32)
    return list(tokens), list(dur)


def train_batch_arrays(B=TRAIN_B, duration_classes=(), seed=0):
    """The bench train batch in numpy: B utterances of N_PHONES, random
    mel / f0 / energy; the classed plan when ``duration_classes`` is given
    (caps bucketed by 64), else the single-class plan with B*N_PHONES
    segments.  Returns (Batch, olens)."""
    from fcl_taco2_tpu_torch.ops.regroup import (build_classed_plan,
                                                 build_plan,
                                                 duration_class_caps)
    rng = np.random.default_rng(seed)
    Tmax = N_PHONES
    durations = np.clip(rng.poisson(MEAN_DUR, (B, Tmax)), 1,
                        MAX_DUR).astype(np.int32)
    olens = durations.sum(1).astype(np.int32)
    Lmax = int(np.ceil(olens.max() / 64) * 64)
    common = dict(
        tokens=rng.integers(1, IDIM, (B, Tmax)).astype(np.int32),
        ilens=np.full(B, Tmax, np.int32),
        mel=rng.normal(size=(B, Lmax, ODIM)).astype(np.float32),
        olens=olens, durations=durations,
        f0=rng.normal(size=(B, Tmax, 1)).astype(np.float32),
        energy=rng.normal(size=(B, Tmax, 1)).astype(np.float32))
    if duration_classes:
        caps = duration_class_caps(list(durations), duration_classes, B,
                                   cap_bucket=64)
        plan = build_classed_plan(durations, olens, duration_classes, caps,
                                  Lmax)
    else:
        plan = build_plan(durations, olens, MAX_DUR, B * Tmax, Lmax)
    return plan_batch(plan, **common), olens


def plan_batch(plan, **fields):
    """A numpy ``Batch`` of a regroup plan (classed or single-class) and
    the other ``fields`` given (the rest None)."""
    from fcl_taco2_tpu_torch.models.taco2_sa import Batch, SegClass
    rest = dict(tokens=None, ilens=None, mel=None, olens=None,
                durations=None, f0=None, energy=None)
    rest.update(fields)
    if hasattr(plan, "classes"):
        return Batch(
            seg_utt=None, seg_tok=None, seg_start=None, frame_mask=None,
            position=None, utt_gather=plan.utt_gather,
            utt_mask=plan.utt_mask,
            seg_classes=tuple(
                SegClass(c.seg_utt, c.seg_tok, c.seg_start, c.frame_mask,
                         c.position) for c in plan.classes), **rest)
    return Batch(
        seg_utt=plan.seg_utt, seg_tok=plan.seg_tok,
        seg_start=plan.seg_start, frame_mask=plan.frame_mask,
        position=plan.position, utt_gather=plan.utt_gather,
        utt_mask=plan.utt_mask, **rest)


def cell_plans(seed=0, B=64, corpus=2048):
    """The regroup plans of one batch of ``B`` utterances shaped like the
    training cells' corpus (``benchmark/traffic/kd_b64.json``: N(71, 22)
    phonemes in 12..112, Poisson(8) frames in 1..50), at the shapes
    ``BatchConverter.fit_corpus`` fits to ``corpus`` such utterances
    (Tmax and Lmax rounded up to 8 and 64, class caps and the segment
    count bucketed by 64).  Returns (durations (B, Tmax) int32, olens,
    the classed plan over ``DURATION_CLASSES``, the single-class plan)."""
    from fcl_taco2_tpu_torch.ops.regroup import (build_classed_plan,
                                                 build_plan,
                                                 duration_class_caps)
    rng = np.random.default_rng(seed)
    n = np.clip(np.rint(rng.normal(71, 22, corpus)), 12, 112).astype(int)
    durs = [np.clip(rng.poisson(MEAN_DUR, k), 1, MAX_DUR).astype(np.int32)
            for k in n]
    Tmax = -(-int(n.max()) // 8) * 8
    Lmax = -(-max(int(d.sum()) for d in durs) // 64) * 64
    caps = duration_class_caps(durs, DURATION_CLASSES, B, cap_bucket=64)
    P = -(-int(np.sort(n)[::-1][:B].sum()) // 64) * 64
    durations = np.zeros((B, Tmax), np.int32)
    for i, j in enumerate(rng.choice(corpus, B, replace=False)):
        durations[i, :n[j]] = durs[j]
    olens = durations.sum(1).astype(np.int32)
    return (durations, olens,
            build_classed_plan(durations, olens, DURATION_CLASSES, caps,
                               Lmax),
            build_plan(durations, olens, MAX_DUR, P, Lmax))


def train_batch(B, duration_classes, device, seed=0):
    """``train_batch_arrays`` on ``device``: (Batch, olens)."""
    from fcl_taco2_tpu_torch.data.loader import BatchUploader
    batch, olens = train_batch_arrays(B, duration_classes, seed)
    return BatchUploader(device)(batch), olens


def teacher(seed=0, **cfg):
    """FCL-taco2-T at the protocol's idim / odim, seeded weights."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    return Tacotron2SA(teacher_config(IDIM, odim=ODIM, **cfg), seed=seed)


def student(seed=0, **cfg):
    """FCL-taco2-S at the protocol's idim / odim, seeded weights."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA, student_config
    return Tacotron2SA(student_config(IDIM, odim=ODIM, **cfg), seed=seed)


def train_step_flops(model, tx, batch, seed=0):
    """FLOPs of one eager train step (forward, the hand-built decoder
    backward, the update), counted by FlopCounterMode; the step is taken
    on ``model``."""
    from fcl_taco2_tpu_torch.train.profiler import cost_analysis
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_train_step,
                                                step_generator)
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    step = make_train_step(tx, graphed=False)
    dev = next(model.parameters()).device
    return int(cost_analysis(step, ts, batch,
                             step_generator(seed, 0, dev))["flops"])


def rate_row(name, ms, amount, unit, **extra):
    """A row of ``amount`` per second from readings of ``ms`` each: the
    rate's median, min, max and count, the readings' ms beside (with the
    card's clocks where the readings carry them), the card and its power
    limit."""
    rates = [amount / (m / 1e3) for m in ms]
    return {"name": name, unit: timing.spread(rates),
            "ms": timing.spread(ms), "card": timing.card()["smi"], **extra}


def write(path, **sections):
    """Update ``sections`` in the JSON file at ``path``, keeping its other
    keys."""
    payload = {}
    if os.path.exists(path):
        with open(path) as f:
            payload = json.load(f)
    payload.update(sections)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def _is_spread(x):
    return isinstance(x, dict) and {"median", "min", "max", "n"} <= set(x)


def merge_processes(payloads):
    """One results payload from the same script run in several processes:
    the first process's payload with ``across_processes`` beside each of
    its timing spreads (``timing.spread``'s dicts): every process's
    median, their min, max and range over their median.  The payloads
    must have the same rows in the same order (a row's ``name`` and the
    length of every list of rows agree)."""
    def walk(nodes, path):
        head = nodes[0]
        if _is_spread(head):
            meds = [float(n["median"]) for n in nodes]
            mid = float(np.median(meds))
            head["across_processes"] = {
                "medians": meds, "min": min(meds), "max": max(meds),
                "rel_range": (max(meds) - min(meds)) / mid if mid else None}
        elif isinstance(head, dict):
            names = [n.get("name") for n in nodes]
            if any(name != names[0] for name in names):
                raise ValueError(f"{path}: rows {names}")
            for k in head:
                if all(isinstance(n, dict) and k in n for n in nodes):
                    walk([n[k] for n in nodes], f"{path}.{k}")
        elif isinstance(head, list) and any(isinstance(v, (dict, list))
                                            for v in head):
            if any(len(n) != len(head) for n in nodes):
                raise ValueError(f"{path}: lists of "
                                 f"{[len(n) for n in nodes]} rows")
            for i in range(len(head)):
                walk([n[i] for n in nodes], f"{path}[{i}]")

    merged = json.loads(json.dumps(payloads[0]))
    walk([merged] + [json.loads(json.dumps(p)) for p in payloads[1:]], "")
    return merged


class tf32:
    """TF32 products allowed (``on``) or not in cuBLAS matmuls and cuDNN
    convolutions inside the block, the previous switches restored after
    it (``tf32(False)``: fp32 comparisons and fp32 timings)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
