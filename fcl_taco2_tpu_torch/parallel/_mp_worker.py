"""Multi-process worker: deterministic workloads under
``torch.distributed``, so the data-parallel paths run across real
processes (port of ``fcl_taco2_tpu/parallel/_mp_worker.py``).

    python -m fcl_taco2_tpu_torch.parallel._mp_worker --process-id I \\
        --num-processes N --port P --mode all --out r.json

Start one such process a rank (rank 0 listens on ``--port``).  Rank I
runs on ``cuda:I`` and raises without a card unless ``--device`` names
another (``cpu`` runs the plain versions over gloo).  Modes:

- ``dp``       data-parallel train steps through ``make_global_batch``;
- ``classed``  the same on the duration-classed plan (classes (2, 4));
- ``kd``       the knowledge-distillation step;
- ``serve``    sharded serving (``Synthesizer(mesh=...)``);
- ``bn``       synchronized train-mode BatchNorm, forward and backward,
               with a mask and without;
- ``hybrid``   ``dp`` over the flat mesh and over
               ``make_hybrid_mesh(--n-slices)``;
- ``all``      ``dp`` (``--save-ckpt`` after ``--save-step``), ``classed``,
               ``kd``, ``serve`` and ``bn`` in one set of processes; with
               ``--corpus`` (a learnable corpus, ``data/synthetic.py``)
               then ``Trainer`` (2 epochs), ``KDTrainer`` (1 epoch, from
               the first run's snapshot) and ``fcl_synth --n-devices N``
               on that snapshot, tiny widths.

``--resume-ckpt`` restores ``dp`` from a snapshot first; ``--lr`` sets
Adam's learning rate (default ``LR``).  ``--params``: an
``.npz`` of JAX trees (``utils/params.py::save_trees_npz``: ``params`` and
``state`` of the tiny model, ``kd_params``/``kd_state`` and
``teacher_params``/``teacher_state`` for KD), so a test hands every rank
the JAX package's initial weights.  ``--width full`` runs the published
widths instead of the tiny config (FCL-taco2-T trains on the benchmark's
16-utterance batch, FCL-taco2-S distils from it, both serve), for the
card.  Process 0 writes the result JSON to ``--out`` and the arrays (mels,
BatchNorm outputs) to ``<out>.npz``; each rank's kernel launches are
gathered into the JSON (``launches``, one row a rank).
"""

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

TINY_STEPS_SEED, KD_SEED, SERVE_SEED = 100, 200, 5
NO_DROPOUT = dict(dropout_rate=0.0, zoneout_rate=0.0,
                  duration_predictor_dropout_rate=0.0,
                  pitch_predictor_dropout_rate=0.0,
                  energy_predictor_dropout_rate=0.0,
                  pitch_embed_dropout_rate=0.0,
                  energy_embed_dropout_rate=0.0)
# --width full: the benchmark's protocol (bench.py: 70 tokens, 80 mels,
# 96 phonemes, Poisson(8) durations in [1, 50], classes 8,16,32,50)
IDIM, ODIM, N_PHONES, MEAN_DUR, MAX_DUR = 70, 80, 96, 8, 50
FULL_CLASSES = (8, 16, 32, 50)
# Adam's learning rate: JAX's worker's at tiny widths; at full width a
# step of 1e-3 from random weights on the random batch throws the loss
# from 12.7 to 103, a spike that amplifies fp32 summation-order noise
# (1e-7) past 2e-4 by the third step: one process fed the same batch in
# another utterance order departs as far as 2 ranks do
# (scripts/torch_parallel_witness.py), so the comparison of n ranks with
# one would measure the spike's conditioning, not the ranks' sums
LR = {"tiny": 1e-3, "full": 1e-4}


def _tiny_cfg(**over):
    """The JAX worker's tiny config (``_mp_worker.py:37-53``), every
    stochastic knob at 0."""
    from fcl_taco2_tpu_torch.models import ModelConfig

    base = dict(
        idim=11, odim=8, embed_dim=16, eunits=16, econv_layers=2,
        econv_chans=16, dunits=16, prenet_units=8, postnet_layers=3,
        postnet_chans=8, duration_predictor_chans=8,
        pitch_predictor_chans=8, energy_predictor_chans=8, max_dur=4,
        compute_dtype="float32", **NO_DROPOUT)
    base.update(over)
    return ModelConfig(**base)


def _plan_batch(durations, common, max_dur, classes, cap_bucket):
    """A numpy ``Batch`` of ``common`` with the single-class plan (one
    segment slot a token) or the classed one."""
    from fcl_taco2_tpu_torch.models.taco2_sa import Batch, SegClass
    from fcl_taco2_tpu_torch.ops.regroup import (build_classed_plan,
                                                 build_plan,
                                                 duration_class_caps)
    B, Tmax = durations.shape
    olens, Lmax = common["olens"], common["mel"].shape[1]
    if classes:
        caps = duration_class_caps(list(durations), classes, B,
                                   cap_bucket=cap_bucket)
        plan = build_classed_plan(durations, olens, classes, caps, Lmax)
        return Batch(
            seg_utt=None, seg_tok=None, seg_start=None, frame_mask=None,
            position=None, utt_gather=plan.utt_gather,
            utt_mask=plan.utt_mask,
            seg_classes=tuple(
                SegClass(c.seg_utt, c.seg_tok, c.seg_start, c.frame_mask,
                         c.position) for c in plan.classes),
            **common)
    plan = build_plan(durations, olens, max_dur, B * Tmax, Lmax)
    return Batch(
        seg_utt=plan.seg_utt, seg_tok=plan.seg_tok,
        seg_start=plan.seg_start, frame_mask=plan.frame_mask,
        position=plan.position, utt_gather=plan.utt_gather,
        utt_mask=plan.utt_mask, **common)


def _tiny_batch(cfg, B=8, Tmax=4, classes=()):
    """The JAX worker's tiny numpy batch (``_mp_worker.py:56-86``)."""
    rng = np.random.default_rng(0)
    durations = rng.integers(1, cfg.max_dur + 1, (B, Tmax)).astype(np.int32)
    olens = durations.sum(1).astype(np.int32)
    Lmax = int(olens.max())
    common = dict(
        tokens=rng.integers(1, cfg.idim, (B, Tmax)).astype(np.int32),
        ilens=np.full(B, Tmax, np.int32),
        mel=rng.normal(size=(B, Lmax, cfg.odim)).astype(np.float32),
        olens=olens, durations=durations,
        f0=rng.normal(size=(B, Tmax, 1)).astype(np.float32),
        energy=rng.normal(size=(B, Tmax, 1)).astype(np.float32))
    return _plan_batch(durations, common, cfg.max_dur, classes, 8)


def _bench_batch(B=16, classes=FULL_CLASSES, seed=0, order=None):
    """The benchmark's train batch (``bench.py::_train_batch``): B
    utterances of 96 phonemes, Poisson(8) durations clipped to [1, 50],
    random mel / f0 / energy; classed plan, caps bucketed by 64.
    ``order``: the utterances in this order (the same batch, summed in
    another order)."""
    rng = np.random.default_rng(seed)
    dur = np.clip(rng.poisson(MEAN_DUR, (B, N_PHONES)), 1,
                  MAX_DUR).astype(np.int32)
    olens = dur.sum(1).astype(np.int32)
    Lmax = int(np.ceil(olens.max() / 64) * 64)
    common = dict(
        tokens=rng.integers(1, IDIM, (B, N_PHONES)).astype(np.int32),
        ilens=np.full(B, N_PHONES, np.int32),
        mel=rng.normal(size=(B, Lmax, ODIM)).astype(np.float32),
        olens=olens, durations=dur,
        f0=rng.normal(size=(B, N_PHONES, 1)).astype(np.float32),
        energy=rng.normal(size=(B, N_PHONES, 1)).astype(np.float32))
    if order is not None:
        dur = dur[order]
        common = {k: v[order] for k, v in common.items()}
    return _plan_batch(dur, common, MAX_DUR, classes, 64)


def _configs(width, classes=()):
    """(config, KD teacher config, KD student config) of a width."""
    from fcl_taco2_tpu_torch.models import student_config, teacher_config
    if width == "tiny":
        return (_tiny_cfg(duration_classes=classes), _tiny_cfg(
            embed_dim=24, eunits=24, econv_chans=24, dunits=24),
            _tiny_cfg())
    full = dict(odim=ODIM, compute_dtype="float32", **NO_DROPOUT)
    return (teacher_config(IDIM, **full), teacher_config(IDIM, **full),
            student_config(IDIM, **full))


def _load(model, params, tree, state):
    if params is not None:
        from fcl_taco2_tpu_torch.utils.params import params_from_jax
        sd = params_from_jax(params[tree], params[state])
        model.load_state_dict({k: v.to(model.device) for k, v in sd.items()})
    return model


def _checksum(model):
    """Sum of |parameter| over every parameter (the JAX worker's
    ``_checksum`` of ``ts.params``)."""
    return float(sum(float(p.detach().abs().double().sum())
                     for p in model.parameters()))


def _mesh(mesh):
    from fcl_taco2_tpu_torch.parallel.mesh import make_mesh
    return make_mesh() if mesh is None else mesh


def _device(device):
    """The card unless the caller asks for the CPU: raises without one."""
    from fcl_taco2_tpu_torch.utils.device import resolve_device
    return resolve_device(device)


def _upload(mesh, batch, device):
    from fcl_taco2_tpu_torch.data.loader import BatchUploader
    from fcl_taco2_tpu_torch.parallel.distributed import make_global_batch
    return BatchUploader(device)(make_global_batch(mesh, batch))


def run_training_steps(n_steps=3, classes=(), save_ckpt=None, save_step=None,
                       resume_ckpt=None, checksum_steps=(), params=None,
                       device="cuda", mesh=None, width="tiny", lr=None,
                       order=None):
    """Data-parallel train steps (``_mp_worker.py:97-173``): every rank
    builds the same global batch and steps on its share; returns (losses,
    params checksum, {step count: checksum} for ``checksum_steps``,
    grad norms).
    Step k draws from ``step_generator(100, k, rank)``, keyed by the
    absolute step, so a run resumed from ``resume_ckpt`` continues an
    uninterrupted one.  ``save_ckpt`` is written by rank 0 after step
    ``save_step`` (default: the last).  ``lr``: Adam's (default ``LR``);
    ``order``: the full-width batch's utterance order (``_bench_batch``)."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import make_train_step, step_generator

    mesh, device = _mesh(mesh), _device(device)
    cfg = _configs(width, classes)[0]
    model = _load(Tacotron2SA(cfg, device=device, seed=0), params, "params",
                  "state")
    batch = _upload(mesh, _tiny_batch(cfg, classes=classes)
                    if width == "tiny" else _bench_batch(order=order), device)
    tx = build_optimizer(lr=LR[width] if lr is None else lr, grad_clip=1.0)
    names, ps = zip(*model.named_parameters())
    ts = TrainState(model, tx.init(ps, names), 0, tx)
    mesh.broadcast_module_(model)
    if resume_ckpt:
        ts, _, _ = restore_checkpoint(resume_ckpt, ts)
        mesh.broadcast_module_(model)
    step = make_train_step(tx, mesh=mesh)
    save_step = n_steps if save_step is None else save_step
    losses, mid, norms = [], {}, []
    for i in range(n_steps):
        ts, report = step(ts, batch, step_generator(
            TINY_STEPS_SEED, ts.step, device, mesh.rank))
        losses.append(float(report["loss"]))
        norms.append(float(report["grad_norm"]))
        if (i + 1) in checksum_steps:
            mid[i + 1] = _checksum(model)
        if save_ckpt and i + 1 == save_step and mesh.rank == 0:
            save_checkpoint(save_ckpt, ts, epoch=0)
    return losses, _checksum(model), mid, norms


def run_kd_steps(n_steps=2, params=None, device="cuda", mesh=None,
                 width="tiny"):
    """KD steps (``_mp_worker.py:176-205``): the frozen teacher and the
    student's update on every rank's share; returns (losses, student
    checksum, the projections included)."""
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_kd_train_step,
                                                step_generator)

    mesh, device = _mesh(mesh), _device(device)
    _, tcfg, scfg = _configs(width)
    kd = KDStudent(scfg, tcfg, device=device, seed=0)
    _load(kd.student, params, "kd_params", "kd_state")
    _load(kd.teacher, params, "teacher_params", "teacher_state")
    batch = _upload(mesh, _tiny_batch(scfg) if width == "tiny"
                    else _bench_batch(), device)
    tx = build_optimizer(lr=LR[width], grad_clip=1.0)
    names, ps = zip(*kd.student.named_parameters())
    ts = TrainState(kd.student, tx.init(ps, names), 0, tx)
    mesh.broadcast_module_(kd.student)
    mesh.broadcast_module_(kd.teacher)
    step = make_kd_train_step(kd, tx, mesh)
    losses = []
    for i in range(n_steps):
        ts, report = step(ts, batch, step_generator(KD_SEED, i, device,
                                                    mesh.rank))
        losses.append(float(report["loss"]))
    return losses, _checksum(kd.student)


def serve_requests(width, seed=3):
    """The serving workload: (token lists, durations, batch size,
    Synthesizer keywords).  Tiny: the JAX worker's 8 utterances of 4
    tokens (``_mp_worker.py:208-231``) and durations in [1, 4] for them
    (the JAX worker predicts them: pass None for that); full: 4
    benchmark utterances of 96 phonemes with their durations."""
    rng = np.random.default_rng(seed)
    if width == "tiny":
        toks = [rng.integers(1, 11, 4).astype(np.int32) for _ in range(8)]
        durs = [np.random.default_rng(seed + 1 + i).integers(
            1, 5, 4).astype(np.int32) for i in range(8)]
        return toks, durs, 8, dict(tok_bucket=4, frame_bucket=16)
    toks = [rng.integers(1, IDIM, N_PHONES).astype(np.int32)
            for _ in range(4)]
    durs = [np.clip(rng.poisson(MEAN_DUR, N_PHONES), 1,
                    MAX_DUR).astype(np.int32) for _ in range(4)]
    return toks, durs, 4, {}


def _serve_models(width, params, device):
    """{name: model} of the serving workload: the tiny model, or at full
    width FCL-taco2-T and FCL-taco2-S (dropout 0) in fp32 compute and in
    bf16 compute ("<name>_bf16", the same weights).  The decoder kernels
    keep their weight dtypes in fp32 compute: bf16 streamed for the
    teacher, fp32 for the student."""
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    if width == "tiny":
        return {"tiny": _load(Tacotron2SA(_tiny_cfg(), device=device,
                                          seed=0), params, "params",
                              "state")}
    models = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        over = dict(odim=ODIM, compute_dtype=dtype, **NO_DROPOUT)
        models["teacher" + sfx] = Tacotron2SA(teacher_config(IDIM, **over),
                                              device=device, seed=0)
        models["student" + sfx] = Tacotron2SA(student_config(IDIM, **over),
                                              device=device, seed=0)
    return models


def run_serving(params=None, device="cuda", mesh=None, width="tiny",
                shares=1):
    """Sharded serving (``_mp_worker.py:208-231``): every rank decodes its
    rows and reads back every mel.  Returns {case: (mels, total
    frames)}: the tiny model with predicted durations ("tiny", the JAX
    worker's case) and given ones ("tiny_dur"), or at full width every
    model of ``_serve_models``, durations given.  ``shares``: decode the
    batch in this process as that many batches of consecutive
    utterances, each of what one rank of a ``shares``-rank mesh decodes
    (the same rows, shapes and frame budget)."""
    from fcl_taco2_tpu_torch.infer.synth import Synthesizer
    mesh, device = _mesh(mesh), _device(device)
    if shares > 1 and mesh.distributed:
        raise ValueError("shares are decoded in one process, without a mesh")
    toks, durs, B, kw = serve_requests(width)
    b = B // shares
    out = {}
    for name, model in _serve_models(width, params, device).items():
        mesh.broadcast_module_(model)
        synth = Synthesizer(model, batch_size=b, device=device, mesh=mesh,
                            **kw)
        cases = {name: durs} if width == "full" \
            else {name: None, name + "_dur": durs}
        for case, dd in cases.items():
            mels, frames = [], 0
            for s in range(shares):
                rows = slice(s * b, s * b + b)
                m, stats = synth.synth_batch(
                    toks[rows], SERVE_SEED,
                    durations=None if dd is None else dd[rows])
                mels += m
                frames += int(stats["total_frames"])
            out[case] = (mels, frames)
    return out


def check_synced_bn(mesh=None, device="cuda", seed=7):
    """Train-mode BatchNorm on every rank's rows of one seeded (B=4, T=6,
    C=3) input, synchronized over the ranks, with a length mask and
    without: returns {case: {name: array}} with the outputs and input
    gradients gathered to full size, the parameter gradients summed, and
    the new running statistics, for a test to hold against one rank on
    the whole input."""
    from fcl_taco2_tpu_torch.ops.conv import batch_norm_train, \
        synced_batch_norm
    from fcl_taco2_tpu_torch.ops.masking import lengths_to_non_pad_mask
    mesh, device = _mesh(mesh), _device(device)
    x, gy, w, b, rm, rv, lens = bn_inputs(seed)
    n = x.shape[0] // mesh.size
    rows = slice(mesh.rank * n, mesh.rank * n + n)
    out = {}
    for case in ("masked", "unmasked"):
        t = {k: torch.tensor(v, device=device) for k, v in
             dict(x=x[rows], gy=gy[rows], w=w, b=b, rm=rm, rv=rv).items()}
        for k in ("x", "w", "b"):
            t[k].requires_grad_(True)
        mask = lengths_to_non_pad_mask(torch.tensor(lens[rows], device=device),
                                       x.shape[1]) if case == "masked" \
            else None
        with synced_batch_norm(mesh):
            y, (nm, nv) = batch_norm_train(t["x"], t["w"], t["b"], t["rm"],
                                           t["rv"], mask=mask)
            (y * t["gy"]).sum().backward()

        def full(v):
            buf = v.new_zeros((x.shape[0],) + tuple(v.shape[1:]))
            buf[rows] = v
            return mesh.all_reduce_(buf)
        out[case] = {
            "y": full(y.detach()), "dx": full(t["x"].grad),
            "dw": mesh.all_reduce_(t["w"].grad.clone()),
            "db": mesh.all_reduce_(t["b"].grad.clone()),
            "mean": nm, "var": nv}
        out[case] = {k: v.cpu().numpy() for k, v in out[case].items()}
    return out


def bn_inputs(seed=7):
    """``check_synced_bn``'s inputs: x, the output gradient, weight, bias,
    running mean and variance, and the utterance lengths."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(4, 6, 3)).astype(f) * 2 + 1,
            rng.normal(size=(4, 6, 3)).astype(f),
            rng.normal(size=3).astype(f), rng.normal(size=3).astype(f),
            rng.normal(size=3).astype(f), rng.uniform(0.5, 2, 3).astype(f),
            np.array([6, 3, 5, 2], np.int64))


def synth_cli_args(corpus, world):
    """``fcl_synth``'s arguments for the ``Trainer`` snapshot that
    ``run_trainers`` wrote for a world of ``world`` ranks: the corpus's
    valid manifest, given durations, batches of 4."""
    return ["--model", os.path.join(corpus, f"world{world}", "train",
                                    "snapshot.ep.2"),
            "--json", os.path.join(corpus, "valid.json"),
            "--batch-size", "4", "--use-gt-durations"]


def run_trainers(corpus, mesh=None, device="cuda"):
    """``Trainer`` then ``KDTrainer`` at tiny widths, every stochastic
    knob at 0, on ``corpus`` (``write_learnable_corpus(corpus, ...,
    max_dur=4)``), streaming one step a dispatch, the ``Trainer``'s first
    epoch profiled (``train/prof``); runs in ``corpus/world<N>``.  Returns {"train": log entries, "kd": log
    entries} (rank 0's ``log.jsonl``: epoch, main/loss,
    validation/main/loss)."""
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.distill import KDTrainer
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer

    mesh, device = _mesh(mesh), _device(device)
    train = load_manifest(os.path.join(corpus, "train.json"))
    valid = load_manifest(os.path.join(corpus, "valid.json"))
    root = os.path.join(corpus, f"world{mesh.size}")
    out = {}
    for name, epochs in (("train", 2), ("kd", 1)):
        tcfg = TrainConfig(exp_dir=os.path.join(root, name), epochs=epochs,
                           batch_size=4, seed=1, device_cache="off",
                           steps_per_dispatch=1, plot_interval_epochs=0,
                           profile_dir=os.path.join(root, name, "prof")
                           if name == "train" else None)
        if name == "train":
            trainer = Trainer(Tacotron2SA(_tiny_cfg(), device=device,
                                          seed=0), tcfg, train, valid,
                              device=device, mesh=mesh)
        else:
            scfg = _tiny_cfg(embed_dim=8, eunits=8, econv_chans=8,
                             dunits=12, prenet_units=6, postnet_chans=6)
            kd = KDStudent(scfg, _tiny_cfg(), device=device, seed=0)
            trainer = KDTrainer(kd, tcfg, train, valid, device=device,
                                mesh=mesh, teacher_checkpoint=os.path.join(
                                    root, "train", "snapshot.ep.2"))
        trainer.run()
        if mesh.size > 1:  # rank 0's files are written before any reads
            dist.barrier()
        if mesh.rank == 0:
            with open(os.path.join(tcfg.exp_dir, "log.jsonl")) as f:
                out[name] = [{k: v for k, v in json.loads(line).items()
                              if k in ("epoch", "step", "main/loss",
                                       "validation/main/loss")}
                             for line in f]
    return out


def _counts():
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    return [K.fused_ar_decode, K.fused_ar_decode_hbm]


def _gather_launches(mesh, device):
    """Every rank's decoder-kernel launch counts, one row a rank."""
    fns = _counts()
    buf = torch.zeros(mesh.size, len(fns), dtype=torch.float64,
                      device=device)
    buf[mesh.rank] = torch.tensor([float(f.launches) for f in fns])
    mesh.all_reduce_(buf)
    return {f.__name__: [int(v) for v in buf[:, i]]
            for i, f in enumerate(fns)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mode", default="dp",
                    choices=("dp", "classed", "kd", "serve", "bn",
                             "hybrid", "all"))
    ap.add_argument("--corpus", type=str, default=None,
                    help="all: then the trainers and fcl_synth on this "
                         "learnable corpus")
    ap.add_argument("--lr", type=float, default=None,
                    help="dp: Adam's learning rate (default: LR)")
    ap.add_argument("--width", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--save-ckpt", type=str, default=None,
                    help="dp: rank 0 saves a checkpoint after --save-step")
    ap.add_argument("--save-step", type=int, default=None,
                    help="the step after which --save-ckpt is written "
                         "(default: the last)")
    ap.add_argument("--resume-ckpt", type=str, default=None,
                    help="dp: restore this checkpoint first")
    ap.add_argument("--n-slices", type=int, default=2,
                    help="hybrid: hosts of the replica x data grouping")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on a card, gloo on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: a card a rank, which must be "
                         "present), cuda:K (every rank on card K: gloo "
                         "only) or cpu")
    ap.add_argument("--params", type=str, default=None,
                    help=".npz of JAX trees (utils/params.py::"
                         "save_trees_npz) to start from")
    ap.add_argument("--out", type=str, default=None,
                    help="process 0 writes the result JSON here")
    args = ap.parse_args(argv)

    from fcl_taco2_tpu_torch.parallel.distributed import (initialize,
                                                          is_multiprocess,
                                                          rank_device)
    from fcl_taco2_tpu_torch.parallel.mesh import (make_hybrid_mesh,
                                                   make_mesh)
    from fcl_taco2_tpu_torch.utils.params import load_trees_npz

    device = _device(rank_device(args.device, args.process_id))
    if device.type == "cuda":  # fp32 runs held to one process: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize(f"localhost:{args.port}", args.num_processes,
               args.process_id, backend=args.backend, device=device)
    if args.num_processes > 1 and not is_multiprocess():
        raise RuntimeError("the process group did not form")
    params = load_trees_npz(args.params) if args.params else None
    mesh = make_mesh(args.num_processes)
    kw = dict(device=device, width=args.width)
    result, arrays = {}, {}
    t0 = time.perf_counter()

    def dp(key, m, **extra):
        # synchronized, so the seconds are the card's too; a graphed step
        # (NCCL) records its all-reduces in its graph, and cannot
        m.timing = not m.captures_collectives
        before = dict(m.stats)
        losses, checksum, mid, norms = run_training_steps(
            args.steps, params=params, mesh=m, lr=args.lr, **kw, **extra)
        result[key] = {"losses": losses, "checksum": checksum,
                       "grad_norms": norms,
                       "checksums": {str(k): v for k, v in mid.items()},
                       "allreduce_per_step": {
                           k: (m.stats[k] - before[k]) / args.steps
                           for k in ("bytes", "calls", "seconds")}}

    if args.mode in ("dp", "all"):
        dp("dp", mesh, save_ckpt=args.save_ckpt, save_step=args.save_step,
           resume_ckpt=args.resume_ckpt,
           checksum_steps=tuple(range(1, args.steps + 1)))
    if args.mode in ("classed", "all") and args.width == "tiny":
        losses, checksum, _, _ = run_training_steps(
            2, classes=(2, 4), params=params, mesh=mesh, **kw)
        result["classed"] = {"losses": losses, "checksum": checksum}
    if args.mode == "hybrid":
        dp("flat", mesh)
        hmesh = make_hybrid_mesh(args.n_slices)
        dp("hybrid", hmesh)
        result["hybrid"]["shape"] = list(hmesh.shape)
    if args.mode in ("kd", "all"):
        losses, checksum = run_kd_steps(
            2 if args.width == "tiny" else 1, params=params, mesh=mesh, **kw)
        result["kd"] = {"losses": losses, "checksum": checksum}
    if args.mode in ("serve", "all"):
        for f in _counts():
            f.launches = 0
        for name, (mels, frames) in run_serving(params=params, mesh=mesh,
                                                **kw).items():
            result[f"serve_{name}"] = {
                "mel_sums": [float(np.abs(m).sum()) for m in mels],
                "total_frames": frames}
            for i, m in enumerate(mels):
                arrays[f"serve_{name}/{i}"] = m
        result["launches"] = _gather_launches(mesh, device)
    if args.mode == "all" and args.corpus:
        from fcl_taco2_tpu_torch.cli import fcl_synth
        result["trainers"] = run_trainers(args.corpus, mesh, device)
        fcl_synth.main(synth_cli_args(args.corpus, mesh.size) + [
            "--device", str(device), "--n-devices", str(mesh.size),
            "--out", os.path.join(args.corpus, f"world{mesh.size}",
                                  "synth")])
    if args.mode in ("bn", "all"):
        for case, vals in check_synced_bn(mesh, device).items():
            for k, v in vals.items():
                arrays[f"bn_{case}/{k}"] = v
    result.update({"mode": args.mode, "num_processes": args.num_processes,
                   "backend": dist.get_backend() if is_multiprocess()
                   else None, "device": str(device),
                   "seconds": time.perf_counter() - t0})
    print(f"proc {args.process_id}: {json.dumps(result)}", flush=True)
    if args.process_id == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
        np.savez(args.out + ".npz", **arrays)
    if is_multiprocess():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
