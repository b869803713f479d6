"""Training orchestration: epochs, evaluation, checkpoints, early stop
(port of ``fcl_taco2_tpu/train/loop.py``).

Replaces the chainer Trainer + extensions wiring (tts.py:309-602):
batchset planning, the prefetching loader, per-epoch validation over the
whole validation split, periodic and best-model snapshots, plots and
log, early stopping on validation loss, sortagrad, resume, and a
checkpoint after the in-flight step on SIGTERM/SIGINT.

Each step's ``torch.Generator`` is derived from ``(seed, step)``
(``step_generator``), so a resumed run draws the same dropout and zoneout
masks as an uninterrupted one.  The single-card runtime is the JAX
trainer's: with ``device_cache="auto"`` the corpus is uploaded once when
it fits in ``device_cache_max_mb`` and each batch is assembled on the
device from a packed plan vector (``data/device_cache.py``); with
``steps_per_dispatch=0`` the trainer then chains 4 steps a dispatch (1
without the cache), on the card as replays of one CUDA graph of the step
(``train/step.py::make_chained_train_step``); an epoch's remainder
replays the same graph.  Single steps (``--device-cache off``, KD) and
eval steps are graph replays too, one graph per batch shape, as JAX jits
them; ``log.jsonl``'s ``capture_s`` and ``graph_pool_bytes`` say what the
captures cost.  Fine-tuning
(``enc_init``/``dec_init``, ``freeze_mods``, ``train/finetune.py``), the
``preprocess_conf`` transform (``data/transform.py``) and the profiler
trace of the first epoch (``profile_dir``, ``train/profiler.py``) are
wired as in the JAX package.  KD runs through
``train/distill.py::KDTrainer``.

Data parallel (``n_devices``/``n_slices``, ``parallel/``): one process a
card, each building the same global batches and training on its share
of them (``make_global_batch``), with the global batch's losses and
gradients (``train/step.py``), so n ranks train as one does.  As in JAX
(``loop.py:121-133``, ``:183``, ``:218-222``, ``:289``, ``:382-392``)
the batch size must divide by the ranks, a batch holds at least one
utterance a rank, and a run of several ranks streams from the host
(no device cache), runs one step a dispatch and does not checkpoint on
a signal.  Rank 0 alone writes checkpoints, ``model.json``, the log and
the plots, each rank its own profiler trace; every rank restores, and takes rank 0's parameters at the
start and after a restore.
"""

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from fcl_taco2_tpu_torch.data.batchfy import make_batchset
from fcl_taco2_tpu_torch.data.converter import BatchConverter
from fcl_taco2_tpu_torch.data.loader import BatchUploader, PrefetchLoader
from fcl_taco2_tpu_torch.parallel.distributed import make_global_batch
from fcl_taco2_tpu_torch.parallel.mesh import mesh_for
from fcl_taco2_tpu_torch.train.checkpoint import (AsyncCheckpointWriter,
                                                  restore_checkpoint,
                                                  save_checkpoint,
                                                  save_model_json)
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.profiler import StepTimer, trace
from fcl_taco2_tpu_torch.train.reporter import Reporter
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import (make_chained_train_step,
                                            make_eval_step, make_train_step,
                                            pack_report, step_generator)
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
    # K optimizer steps a dispatch (make_chained_train_step); 0 = auto:
    # 4 with the device cache, 1 without it; > 1 needs fixed_shapes
    steps_per_dispatch: int = 0
    ckpt_opt_dtype: Optional[str] = None  # e.g. "bfloat16" moments on disk
    # device-resident dataset cache (data/device_cache.py): "auto" builds
    # it when supported and within device_cache_max_mb (else says why it
    # streams), "on" raises where it cannot be built, "off" streams
    device_cache: str = "auto"
    device_cache_max_mb: int = 2048
    checkpoint_on_signal: bool = False


class Trainer:
    """``device`` defaults to ``"cuda"`` and raises when no card is present
    (``utils/device.py``); the model moves there.  ``mesh``: the ranks of
    a data-parallel run (``parallel/mesh.py``); by default the one that
    ``tcfg.n_devices`` / ``n_slices`` name over the process group this
    process has joined (``parallel.distributed.initialize``)."""

    def __init__(self, model, tcfg: TrainConfig, train_utts, val_utts,
                 device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None \
            else mesh_for(tcfg.n_devices, tcfg.n_slices)
        n_data = self.mesh.size
        if tcfg.batch_size % n_data:
            raise ValueError(
                f"batch_size {tcfg.batch_size} not divisible by data-"
                f"parallel degree {n_data}")
        self.rank0 = self.mesh.rank == 0  # writes the run's files
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.train_utts = train_utts
        self.val_utts = val_utts
        cfg = model.cfg
        self.converter = BatchConverter(
            max_dur=cfg.max_dur, batch_size=tcfg.batch_size,
            seg_bucket=max(64, n_data * 8), odim=cfg.odim, cache={},
            duration_classes=cfg.effective_duration_classes)
        if tcfg.preprocess_conf:
            from fcl_taco2_tpu_torch.data.transform import Transformation
            self.converter.transform = Transformation(
                tcfg.preprocess_conf, seed=tcfg.seed)
        if tcfg.fixed_shapes:
            # one shape for the whole run: caps from train + val
            self.converter.fit_corpus(list(train_utts) + list(val_utts))
        self.tx = build_optimizer(
            name=tcfg.opt, lr=tcfg.lr, eps=tcfg.eps,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
            accum_grad=tcfg.accum_grad, noam_model_size=cfg.embed_dim,
            freeze_mods=tcfg.freeze_mods)
        self.uploader = BatchUploader(self.device)
        self._dcache = self._maybe_device_cache()
        self._build_steps()  # after _dcache: the chain assembles from it
        self.reporter = Reporter(tcfg.exp_dir)
        if self.rank0:
            save_model_json(tcfg.exp_dir, cfg,
                            extra={"train_config": dataclasses.asdict(tcfg)})

    def _maybe_device_cache(self):
        """The device-resident dataset cache where configured and
        supported (``loop.py:165-199``)."""
        t = self.tcfg
        if t.device_cache == "off":
            return None
        on = t.device_cache == "on"

        def no(reason):
            if on:
                raise ValueError(f"device_cache=on but {reason}")
            print(f"device_cache: {reason}; streaming from host",
                  flush=True)
            return None

        if not t.fixed_shapes:
            return no("fixed_shapes is off")
        if self.converter.transform is not None:
            return no("a host mel transform (preprocess_conf) is set")
        if self.mesh.size > 1:
            return no("multi-device/multi-process runs stream from host")
        from fcl_taco2_tpu_torch.data.device_cache import (
            DeviceBatchCache, distinct_utterances, estimate_cache_bytes)
        # a validation utterance that is also a training one shares its row
        utts = distinct_utterances(list(self.train_utts)
                                   + list(self.val_utts))
        est = estimate_cache_bytes(self.converter, len(utts))
        if not on and est > t.device_cache_max_mb * (1 << 20):
            return no(f"dataset ~{est / (1 << 20):.0f} MB exceeds "
                      f"device_cache_max_mb={t.device_cache_max_mb}")
        dc = DeviceBatchCache(self.converter, utts, self.device)
        print(f"device_cache: {len(utts)} utterances resident on "
              f"{self.device} ({dc.bytes / (1 << 20):.1f} MB); per-step "
              "H2D is the packed plan vector only", flush=True)
        return dc

    def _build_steps(self):
        """The train, eval and chained steps; ``KDTrainer`` overrides
        this (``loop.py:201-231``)."""
        self.train_step = make_train_step(self.tx, mesh=self.mesh)
        self.eval_step = make_eval_step(mesh=self.mesh)
        self.chain_step = None
        self._spd = self.tcfg.steps_per_dispatch
        if self._spd == 0:  # auto: chain when the batches are plan packs
            self._spd = 4 if self._dcache is not None else 1
        if self._spd > 1 and self.mesh.size > 1:
            print("steps_per_dispatch: disabled on multi-process runs",
                  flush=True)
            self._spd = 1
        if self._spd > 1:
            if not self.tcfg.fixed_shapes:
                raise ValueError("steps_per_dispatch > 1 requires "
                                 "fixed_shapes (one graph for the run)")
            self.chain_step = make_chained_train_step(
                self.tx, assemble=None if self._dcache is None
                else self._dcache.assemble)
            # an epoch's remainder steps take the chain's items one at a
            # time and replay the chain's graph
            self.train_step = self.chain_step.step

    def _run_train_step(self, ts, batch):
        return self.train_step(ts, batch, step_generator(
            self.tcfg.seed, ts.step, self.device, self.mesh.rank))

    def _convert(self, utts):
        """Utterances -> this rank's share of the global numpy batch."""
        return make_global_batch(self.mesh, self.converter(utts))

    def init_state(self) -> TrainState:
        """Partial init from checkpoints (``enc_init``/``dec_init``, in
        that order), the frozen leaves and the parameter report, then a
        fresh optimizer state (``loop.py:253-276``)."""
        from fcl_taco2_tpu_torch.train.finetune import (frozen_paths,
                                                        load_partial)
        from fcl_taco2_tpu_torch.utils.summary import format_param_report
        t = self.tcfg
        for ckpt, mods, tag in ((t.enc_init, t.enc_init_mods, "enc-init"),
                                (t.dec_init, t.dec_init_mods, "dec-init")):
            if ckpt:
                copied = load_partial(self.model, ckpt, mods)
                print(f"{tag}: loaded {len(copied)} tensors from {ckpt} "
                      f"under {list(mods)}", flush=True)
        if t.freeze_mods:
            for p in frozen_paths(self.model, t.freeze_mods):
                print(f"{p} is frozen not to be updated.", flush=True)
        print(format_param_report(self.model), flush=True)
        self.mesh.broadcast_module_(self.model)
        names, params = zip(*self.model.named_parameters())
        return TrainState(self.model, self.tx.init(params, names), 0,
                          self.tx)

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
            min_batch_size=self.mesh.size, shortest_first=shortest_first,
            num_batches=t.minibatches, seed=t.seed + epoch,
            odim=self.model.cfg.odim)

    def _loader(self, batches, train=True, chain=1):
        """Batches for the loop (``loop.py:294-352``).  With ``chain`` > 1
        the batches go in groups of exactly ``chain`` (tagged "chain": a
        (chain, P) tensor of plan packs with the device cache, else a
        list of batches) and the epoch's remainder as single items of the
        same kind (a plan pack or a batch)."""
        # phases never overlap, so toggling the shared converter's mode
        # is safe
        self.converter.transform_train = train
        dc = self._dcache
        if chain <= 1:
            if dc is not None:
                return PrefetchLoader(batches, dc.plan, self.uploader,
                                      finish=dc.assemble)
            return PrefetchLoader(batches, self._convert, self.uploader)
        groups, i = [], 0
        while i + chain <= len(batches):
            groups.append(batches[i:i + chain])
            i += chain
        groups.extend([b] for b in batches[i:])
        one = self.converter if dc is None else dc.plan

        def convert(group):
            if len(group) == 1:
                return ("single", one(group[0]))
            items = [one(b) for b in group]
            return ("chain", items if dc is None else np.stack(items))

        # with the device cache a remainder is a plan pack: the single
        # step is the chain's, assembling it inside its graph
        return PrefetchLoader(groups, convert, self.uploader)

    def _flush(self, pending):
        """Move a chunk of packed per-step reports ((n, n_keys) each) to
        the host in one copy."""
        if not pending:
            return
        rows = torch.cat([r for _, r in pending]).cpu().tolist()
        keys = [k for k, r in pending for _ in range(r.shape[0])]
        for k, row in zip(keys, rows):
            self.reporter.report(dict(zip(k, row)), prefix="main")
        pending.clear()

    def evaluate(self, ts, epoch):
        """Every validation utterance counts (tts.py:71-108): sequential
        chunks, each batch's means weighted by its real utterance count."""
        bs = self.tcfg.batch_size
        batches = [self.val_utts[i:i + bs]
                   for i in range(0, len(self.val_utts), bs)]
        for i, (chunk, batch) in enumerate(zip(
                batches, self._loader(batches, train=False))):
            gen = step_generator(self.tcfg.seed,
                                 EVAL_STREAM + epoch * 100003 + i,
                                 self.device, self.mesh.rank)
            report = self.eval_step(ts, batch, gen)
            self.reporter.report({k: float(v) for k, v in report.items()},
                                 prefix="validation/main",
                                 weight=len(chunk))

    def run(self):
        t = self.tcfg
        preempt = threading.Event()
        prev_handlers = {}
        want_handler = t.checkpoint_on_signal
        if want_handler and self.mesh.size > 1:
            # a signal on one rank would stop it while its peers wait in
            # a collective, and every rank would write the snapshot
            print("checkpoint_on_signal: disabled on multi-process runs "
                  "(uncoordinated preemption would deadlock peers)",
                  flush=True)
            want_handler = False
        if want_handler and \
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
                self.mesh.broadcast_module_(self.model)
                print(f"resumed from {t.resume} at epoch {start_epoch}, "
                      f"step {ts.step} (best_val {best_val:.4f})",
                      flush=True)
            return self._run_epochs(ts, start_epoch, best_val, preempt)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _prepare_chain(self, ts, batches, chain):
        """Capture the chained step's graph before the epoch's loader and
        trace start, from the epoch's first batch; returns the seconds it
        took (0 once captured, and on the CPU)."""
        if self.chain_step is None or self.chain_step.captured \
                or self.device.type != "cuda" or len(batches) < chain:
            return 0.0
        first = self._dcache.plan(batches[0]) if self._dcache is not None \
            else self.converter(batches[0])
        self.chain_step.prepare(ts, self.uploader(first), self.tcfg.seed)
        print(f"chained step: CUDA graph captured in "
              f"{self.chain_step.capture_s:.2f} s (graph pool "
              f"{self.chain_step.pool_bytes / 2 ** 20:.1f} MiB); "
              f"{chain} replays a dispatch", flush=True)
        return self.chain_step.capture_s

    def _run_epochs(self, ts, start_epoch, best_val, preempt):
        t = self.tcfg
        timer = StepTimer()
        bad_epochs = 0
        self.loop_stats = []  # per-epoch wall breakdown
        ckpt_writer = AsyncCheckpointWriter(opt_state_dtype=t.ckpt_opt_dtype)
        K = 8  # dispatches' reports moved to the host K at a time
        captured = 0.0  # capture seconds before this epoch's steps
        for epoch in range(start_epoch, t.epochs):
            ep = {"epoch": epoch + 1, "dispatch_s": 0.0, "fetch_s": 0.0,
                  "first_iter_s": 0.0, "capture_s": 0.0, "steps": 0,
                  "eval_s": 0.0, "ckpt_s": 0.0, "plot_s": 0.0}
            t_epoch = time.perf_counter()
            batches = self._epoch_batches(epoch)
            chain = self._spd if self.chain_step is not None else 1
            ep["capture_s"] = self._prepare_chain(ts, batches, chain)
            captured += ep["capture_s"]
            profile = t.profile_dir is not None and epoch == start_epoch
            rank = self.mesh.rank if self.mesh.size > 1 else None
            with (trace(t.profile_dir, rank) if profile
                  else contextlib.nullcontext()):
                loader = self._loader(batches, chain=chain)
                pending, used = [], 0
                for i, item in enumerate(loader):
                    kind, batch = item if chain > 1 else ("single", item)
                    timer.tic()
                    t0 = time.perf_counter()
                    if kind == "chain":
                        ts, report = self.chain_step(ts, batch, t.seed)
                        keys = self.chain_step.report_keys
                    else:
                        ts, report = self._run_train_step(ts, batch)
                        keys, report = pack_report(report)
                        report = report[None]
                    t1 = time.perf_counter()
                    pending.append((keys, report))
                    if len(pending) >= K:
                        self._flush(pending)
                    t2 = time.perf_counter()
                    ep["dispatch_s"] += t1 - t0
                    ep["fetch_s"] += t2 - t1
                    if i == 0:
                        ep["first_iter_s"] = t2 - t0
                    n_done = report.shape[0]
                    prev_used, used = used, used + n_done
                    ep["steps"] += n_done
                    timer.toc(n=n_done)
                    if t.log_interval_steps > 0 and \
                            used // t.log_interval_steps \
                            > prev_used // t.log_interval_steps:
                        self._flush(pending)
                        loss = self.reporter.peek(
                            ["main/loss"]).get("main/loss")
                        print(f"epoch {epoch + 1:>3} iter {ts.step:>6} "
                              f"loss={loss:.4f}  "
                              f"({timer.summary().get('step_ms_p50', 0):.0f}"
                              " ms/step p50)", flush=True)
                    if preempt.is_set():
                        break
                t0 = time.perf_counter()
                self._flush(pending)
                ep["fetch_s"] += time.perf_counter() - t0
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
            # every step's captures of this epoch (the chain's is
            # _prepare_chain's, before the loader): seconds and pool
            steps = {id(s.graphs): s for s in (self.chain_step,
                                               self.train_step,
                                               self.eval_step)
                     if getattr(s, "captured", False)}.values()
            ep["capture_s"] += sum(s.capture_s for s in steps) - captured
            captured = sum(s.capture_s for s in steps)
            if steps:
                ep["graph_pool_bytes"] = sum(s.pool_bytes for s in steps)
            extra = dict(timer.summary())
            extra.update({k: round(v, 4) for k, v in ep.items()
                          if isinstance(v, float)})
            extra["steps"] = ep["steps"]
            extra["dispatches"] = loader.stats["batches"]
            extra["steps_per_dispatch"] = chain
            extra["device_cache"] = self._dcache is not None
            if "graph_pool_bytes" in ep:
                extra["graph_pool_bytes"] = ep["graph_pool_bytes"]
            if self.device.type == "cuda":  # saved activations dominate it
                extra["max_memory_allocated_gib"] = round(
                    torch.cuda.max_memory_allocated(self.device) / 2 ** 30,
                    3)
            entry = self.reporter.summarize(epoch + 1, ts.step, extra=extra,
                                            write=False)
            if self.rank0:
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
            if (need_snap or improved) and self.rank0:
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
            if t.plot_interval_epochs > 0 and self.rank0 and \
                    (epoch + 1) % t.plot_interval_epochs == 0:
                t0 = time.perf_counter()
                self.reporter.plot()
                ep["plot_s"] = time.perf_counter() - t0
            entry.update({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in ep.items()
                          if k.startswith("ckpt") or k == "plot_s"})
            if self.rank0:
                self.reporter.write_entry(entry)
            self.loop_stats.append(ep)
            if val is not None and t.patience > 0 \
                    and bad_epochs >= t.patience:
                print(f"early stop at epoch {epoch + 1} "
                      f"(patience {t.patience})", flush=True)
                break
        ckpt_writer.wait()  # files exist before run() returns
        if self.rank0:
            self.reporter.plot()
        return ts
