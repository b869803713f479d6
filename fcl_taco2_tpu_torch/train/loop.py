"""Training orchestration: epochs, evaluation, checkpoints, early stop
(port of ``fcl_taco2_tpu/train/loop.py``).

Replaces the chainer Trainer + extensions wiring (tts.py:309-602):
batchset planning, the prefetching loader, per-epoch validation over the
whole validation split, periodic and best-model snapshots, plots and
log, early stopping on validation loss, sortagrad, resume, and a
checkpoint after the in-flight step on SIGTERM/SIGINT.

Each step's ``torch.Generator`` is derived from ``(seed, step)``
(``step_generator``), so a resumed run draws the same dropout and zoneout
masks as an uninterrupted one.  Not ported yet (ROADMAP): the
device-resident dataset cache and chained dispatch
(``device_cache``/``steps_per_dispatch``, A3), multi-device meshes (A5),
the ``--preprocess-conf`` transform and the profiler trace (A3), and
fine-tuning's partial init and freezing (A2).  KD runs through
``train/distill.py::KDTrainer``.
"""

import dataclasses
import os
import signal
import threading
import time
from typing import Optional

import torch

from fcl_taco2_tpu_torch.data.batchfy import make_batchset
from fcl_taco2_tpu_torch.data.converter import BatchConverter
from fcl_taco2_tpu_torch.data.loader import BatchUploader, PrefetchLoader
from fcl_taco2_tpu_torch.ops.rnn import step_seed
from fcl_taco2_tpu_torch.train.checkpoint import (AsyncCheckpointWriter,
                                                  restore_checkpoint,
                                                  save_checkpoint,
                                                  save_model_json)
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.profiler import StepTimer
from fcl_taco2_tpu_torch.train.reporter import Reporter
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import make_eval_step, make_train_step
from fcl_taco2_tpu_torch.utils.device import resolve_device

EVAL_STREAM = 1 << 40  # eval generators: a stream apart from train steps


@dataclasses.dataclass
class TrainConfig:
    """Training knobs; names mirror the reference CLI (tts_train.py:22-372)
    and the JAX package's ``TrainConfig`` (``loop.py:34-113``)."""
    exp_dir: str = "exp/run"
    epochs: int = 100
    batch_size: int = 16
    sort_key: str = "shuffle"
    maxlen_in: int = 150
    maxlen_out: int = 400
    batch_count: str = "auto"
    batch_bins: int = 0
    batch_frames_in: int = 0
    batch_frames_out: int = 0
    batch_frames_inout: int = 0
    minibatches: int = 0          # >0: truncate batchset for smoke runs
    opt: str = "adam"
    lr: float = 1e-3
    eps: float = 1e-6
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    accum_grad: int = 1
    patience: int = 0             # 0 = no early stop
    eval_interval_epochs: int = 1
    save_interval_epochs: int = 1
    sortagrad: int = 0
    log_interval_steps: int = 100  # in-epoch progress line cadence
    plot_interval_epochs: int = 1  # PNG refresh cadence (0 = end only)
    seed: int = 1
    n_devices: Optional[int] = None
    n_slices: int = 1
    resume: Optional[str] = None
    profile_dir: Optional[str] = None
    preprocess_conf: Optional[str] = None
    fixed_shapes: bool = True
    enc_init: Optional[str] = None
    enc_init_mods: tuple = ("enc.",)
    dec_init: Optional[str] = None
    dec_init_mods: tuple = ("dec.",)
    freeze_mods: tuple = ()
    steps_per_dispatch: int = 0   # 0 = auto (1 here); >1 not ported yet
    ckpt_opt_dtype: Optional[str] = None  # e.g. "bfloat16" moments on disk
    device_cache: str = "auto"    # "auto"/"off" stream from host
    device_cache_max_mb: int = 2048
    checkpoint_on_signal: bool = False


def _not_ported(tcfg):
    """The knobs whose features wait for later slices, as errors."""
    later = []
    if (tcfg.n_devices or 1) > 1 or tcfg.n_slices > 1:
        later.append("multi-device training (n_devices/n_slices)")
    if tcfg.steps_per_dispatch > 1:
        later.append("chained dispatch (steps_per_dispatch > 1)")
    if tcfg.device_cache == "on":
        later.append("the device-resident dataset cache (device_cache=on)")
    if tcfg.preprocess_conf:
        later.append("--preprocess-conf transforms")
    if tcfg.profile_dir:
        later.append("the profiler trace (profile_dir)")
    if tcfg.enc_init or tcfg.dec_init:
        later.append("partial init from checkpoints (enc_init/dec_init, "
                     "ROADMAP A2)")
    if later:
        raise NotImplementedError(
            "not ported yet (ROADMAP): " + "; ".join(later))


def step_generator(seed, step, device):
    """The ``torch.Generator`` of train step ``step``: a function of
    ``(seed, step)`` only."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    return gen


class Trainer:
    """``device`` defaults to ``"cuda"`` and raises when no card is present
    (``utils/device.py``); the model moves there."""

    def __init__(self, model, tcfg: TrainConfig, train_utts, val_utts,
                 device="cuda"):
        self.device = resolve_device(device)
        _not_ported(tcfg)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.train_utts = train_utts
        self.val_utts = val_utts
        cfg = model.cfg
        self.converter = BatchConverter(
            max_dur=cfg.max_dur, batch_size=tcfg.batch_size, seg_bucket=64,
            odim=cfg.odim, cache={},
            duration_classes=cfg.effective_duration_classes)
        if tcfg.fixed_shapes:
            # one shape for the whole run: caps from train + val
            self.converter.fit_corpus(list(train_utts) + list(val_utts))
        self.tx = build_optimizer(
            name=tcfg.opt, lr=tcfg.lr, eps=tcfg.eps,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
            accum_grad=tcfg.accum_grad, noam_model_size=cfg.embed_dim,
            freeze_mods=tcfg.freeze_mods)
        self.train_step = make_train_step(self.tx)
        self.eval_step = make_eval_step()
        self.uploader = BatchUploader(self.device)
        self.reporter = Reporter(tcfg.exp_dir)
        save_model_json(tcfg.exp_dir, cfg,
                        extra={"train_config": dataclasses.asdict(tcfg)})

    def init_state(self) -> TrainState:
        params = list(self.model.parameters())
        n = sum(p.numel() for p in params)
        print(f"parameters: {n / 1e6:.2f} M in {len(params)} tensors",
              flush=True)
        return TrainState(self.model, self.tx.init(params), 0)

    def _epoch_batches(self, epoch):
        t = self.tcfg
        shortest_first = 0 < t.sortagrad and epoch < t.sortagrad \
            or t.sortagrad == -1
        return make_batchset(
            self.train_utts, batch_size=t.batch_size, count=t.batch_count,
            sort_key=("input" if shortest_first else t.sort_key),
            max_length_in=t.maxlen_in, max_length_out=t.maxlen_out,
            batch_bins=t.batch_bins, batch_frames_in=t.batch_frames_in,
            batch_frames_out=t.batch_frames_out,
            batch_frames_inout=t.batch_frames_inout,
            shortest_first=shortest_first, num_batches=t.minibatches,
            seed=t.seed + epoch, odim=self.model.cfg.odim)

    def _loader(self, batches):
        return PrefetchLoader(batches, self.converter, self.uploader)

    def _flush(self, pending):
        """Move a chunk of per-step reports to the host in one copy."""
        if not pending:
            return
        keys = sorted(pending[0])
        rows = torch.stack([torch.stack([r[k].float() for k in keys])
                            for r in pending]).cpu().tolist()
        for row in rows:
            self.reporter.report(dict(zip(keys, row)), prefix="main")
        pending.clear()

    def evaluate(self, ts, epoch):
        """Every validation utterance counts (tts.py:71-108): sequential
        chunks, each batch's means weighted by its real utterance count."""
        bs = self.tcfg.batch_size
        batches = [self.val_utts[i:i + bs]
                   for i in range(0, len(self.val_utts), bs)]
        for i, (chunk, batch) in enumerate(zip(batches,
                                               self._loader(batches))):
            gen = step_generator(self.tcfg.seed,
                                 EVAL_STREAM + epoch * 100003 + i,
                                 self.device)
            report = self.eval_step(ts, batch, gen)
            self.reporter.report({k: float(v) for k, v in report.items()},
                                 prefix="validation/main",
                                 weight=len(chunk))

    def run(self):
        t = self.tcfg
        preempt = threading.Event()
        prev_handlers = {}
        if t.checkpoint_on_signal and \
                threading.current_thread() is threading.main_thread():
            def _on_signal(signum, frame):
                print(f"signal {signum}: checkpointing after the in-flight "
                      "step", flush=True)
                preempt.set()
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_signal)
        try:
            ts = self.init_state()
            start_epoch, best_val = 0, float("inf")
            if t.resume:
                ts, start_epoch, best_val = restore_checkpoint(t.resume, ts)
                print(f"resumed from {t.resume} at epoch {start_epoch}, "
                      f"step {ts.step} (best_val {best_val:.4f})",
                      flush=True)
            return self._run_epochs(ts, start_epoch, best_val, preempt)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _run_epochs(self, ts, start_epoch, best_val, preempt):
        t = self.tcfg
        timer = StepTimer()
        bad_epochs = 0
        self.loop_stats = []  # per-epoch wall breakdown
        ckpt_writer = AsyncCheckpointWriter(opt_state_dtype=t.ckpt_opt_dtype)
        K = 8  # reports moved to the host K steps at a time
        for epoch in range(start_epoch, t.epochs):
            ep = {"epoch": epoch + 1, "steps": 0, "eval_s": 0.0,
                  "ckpt_s": 0.0, "plot_s": 0.0}
            t_epoch = time.perf_counter()
            batches = self._epoch_batches(epoch)
            loader = self._loader(batches)
            pending = []
            for batch in loader:
                timer.tic()
                ts, report = self.train_step(
                    ts, batch, step_generator(t.seed, ts.step, self.device))
                pending.append(report)
                if len(pending) >= K:
                    self._flush(pending)
                timer.toc()
                ep["steps"] += 1
                if t.log_interval_steps > 0 and \
                        ts.step % t.log_interval_steps == 0:
                    self._flush(pending)
                    loss = self.reporter.peek(["main/loss"]).get("main/loss")
                    print(f"epoch {epoch + 1:>3} iter {ts.step:>6} "
                          f"loss={loss:.4f}  "
                          f"({timer.summary().get('step_ms_p50', 0):.0f}"
                          " ms/step p50)", flush=True)
                if preempt.is_set():
                    break
            self._flush(pending)
            ep.update({f"loader_{k}": round(v, 4) if k != "batches" else v
                       for k, v in loader.stats.items()})
            ep["train_wall_s"] = time.perf_counter() - t_epoch
            if preempt.is_set():
                try:
                    ckpt_writer.wait()
                except Exception as e:  # the preemption snapshot comes first
                    print("checkpoint writer failed in background: "
                          f"{e!r}; writing snapshot.preempt anyway",
                          flush=True)
                path = os.path.join(t.exp_dir, "snapshot.preempt")
                # THIS epoch's index: resume restarts the cut epoch
                save_checkpoint(path, ts, epoch, best_val=best_val)
                print(f"preempted at epoch {epoch + 1}: saved {path} "
                      "(restart with --resume to continue)", flush=True)
                return ts
            if (epoch + 1) % t.eval_interval_epochs == 0:
                t0 = time.perf_counter()
                self.evaluate(ts, epoch)
                ep["eval_s"] = time.perf_counter() - t0
            extra = dict(timer.summary())
            extra.update({k: round(v, 4) for k, v in ep.items()
                          if isinstance(v, float)})
            extra["steps"] = ep["steps"]
            if self.device.type == "cuda":  # saved activations dominate it
                extra["max_memory_allocated_gib"] = round(
                    torch.cuda.max_memory_allocated(self.device) / 2 ** 30,
                    3)
            entry = self.reporter.summarize(epoch + 1, ts.step, extra=extra,
                                            write=False)
            self.reporter.print_entry(
                entry, keys=["main/loss", "validation/main/loss"])
            val = entry.get("validation/main/loss")
            improved = val is not None and val < best_val
            if improved:
                best_val = val
                bad_epochs = 0
            elif val is not None:
                bad_epochs += 1
            need_snap = (epoch + 1) % t.save_interval_epochs == 0
            if need_snap or improved:
                t0 = time.perf_counter()
                jobs = []
                if need_snap:
                    # droppable while a write is in flight, except the last
                    jobs.append((os.path.join(
                        t.exp_dir, f"snapshot.ep.{epoch + 1}"), epoch + 1,
                        best_val, (epoch + 1) >= t.epochs))
                if improved:
                    jobs.append((os.path.join(t.exp_dir, "model.loss.best"),
                                 epoch + 1, best_val, True))
                ckpt_writer.submit(ts, jobs)
                ep["ckpt_s"] += time.perf_counter() - t0
                ep["ckpt_bg_s"] = round(ckpt_writer.last_bg_s, 4)
                ep["ckpt_skipped"] = ckpt_writer.skipped
                ep["ckpt_coalesced"] = ckpt_writer.coalesced
            if t.plot_interval_epochs > 0 and \
                    (epoch + 1) % t.plot_interval_epochs == 0:
                t0 = time.perf_counter()
                self.reporter.plot()
                ep["plot_s"] = time.perf_counter() - t0
            entry.update({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in ep.items()
                          if k.startswith("ckpt") or k == "plot_s"})
            self.reporter.write_entry(entry)
            self.loop_stats.append(ep)
            if val is not None and t.patience > 0 \
                    and bad_epochs >= t.patience:
                print(f"early stop at epoch {epoch + 1} "
                      f"(patience {t.patience})", flush=True)
                break
        ckpt_writer.wait()  # files exist before run() returns
        self.reporter.plot()
        return ts
