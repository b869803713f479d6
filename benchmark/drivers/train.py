"""Training throughput on the ``fcl_train`` step path, without evaluation
or snapshots: a corpus in ``DeviceBatchCache`` at corpus-fit shapes,
shuffle batching, ``make_chained_train_step`` with ``chain`` steps a
dispatch and each dispatch's plan packs made on the host by the
trainer's ``PrefetchLoader``, the reports moved to the host every eight
dispatches, as ``Trainer`` runs its epochs.

The corpus: the mix's utterances, their mel, pitch and energy targets
drawn on the card from the seed; the features reach the converter through
its in-memory cache, and only the duration vectors go to small files in
``TMPDIR`` (the converter's corpus fit reads them from files), removed at
the end.

Set-up builds the one train state and drives it through its first three
steps by the window's own call; their losses, the first step's gradient
(from Adam's first moment) and the parameters' change after the three are
the answers the plain reference (``reference/train.py``) checks.
"""

import math
import os
import tempfile
import time

import numpy as np
import torch

from benchmark import corpus, weights
from benchmark import trace as tracing
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision

B1 = 0.9  # Adam's first-moment decay: the first moment is (1 - B1) g


def _leaf_norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


class Driver:
    def __init__(self, config, mix, seed, device, options=None):
        """``options``: program options of a control run; the training
        cells' control is the reference, so there are none."""
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.train_seed = corpus.split_seed(seed, "train")
        self.utts = corpus.utterances(mix["corpus"], seed,
                                      int(mix["corpus_size"]))
        B = int(mix["batch"])
        rng = np.random.default_rng(corpus.split_seed(seed, "batches"))
        n = len(self.utts) // B
        self.batches = [list(p[i * B:(i + 1) * B])
                        for p in (rng.permutation(len(self.utts))
                                  for _ in range(int(mix["epochs"])))
                        for i in range(n)]
        self.next = 0

    def model_config(self):
        return dict(self.config["model"],
                    duration_classes=list(self.mix["duration_classes"]))

    # ---- set-up ----
    def _features(self):
        """Each utterance's (mel, durations, f0, energy) in numpy, drawn
        on the card from the seed in three calls."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(corpus.split_seed(self.seed, "features"))
        frames = [u.frames for u in self.utts]
        tokens = [len(u.tokens) for u in self.utts]
        odim = self.config["model"]["odim"]
        mel = torch.randn(sum(frames), odim, generator=gen,
                          device=self.device).cpu().numpy()
        f0 = torch.randn(sum(tokens), 1, generator=gen,
                         device=self.device).cpu().numpy()
        en = torch.randn(sum(tokens), 1, generator=gen,
                         device=self.device).cpu().numpy()
        mels = np.split(mel, np.cumsum(frames)[:-1])
        f0s = np.split(f0, np.cumsum(tokens)[:-1])
        ens = np.split(en, np.cumsum(tokens)[:-1])
        return [(m, u.durations, p, e)
                for m, u, p, e in zip(mels, self.utts, f0s, ens)]

    def build(self):
        from fcl_taco2_tpu_torch.data.converter import BatchConverter
        from fcl_taco2_tpu_torch.data.device_cache import DeviceBatchCache
        from fcl_taco2_tpu_torch.data.loader import BatchUploader
        from fcl_taco2_tpu_torch.data.manifest import Utterance
        from fcl_taco2_tpu_torch.models import ModelConfig
        from fcl_taco2_tpu_torch.train.optim import build_optimizer
        from fcl_taco2_tpu_torch.train.state import TrainState
        mc = ModelConfig(**self.model_config())
        model = self.make_model(mc)
        self.feats = self._features()
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_durations_")
        manifest, cache = [], {}
        for i, (u, f) in enumerate(zip(self.utts, self.feats)):
            uid = f"utt{i:05d}"
            path = os.path.join(self.tmp.name, uid + ".npy")
            np.save(path, u.durations)
            manifest.append(Utterance(
                uid, u.tokens.astype(np.int32), len(u.tokens), u.frames,
                "", path, "", ""))
            cache[uid] = f
        self.manifest = manifest
        self.converter = BatchConverter(
            max_dur=mc.max_dur, batch_size=int(self.mix["batch"]),
            seg_bucket=64, odim=mc.odim, cache=cache,
            duration_classes=mc.effective_duration_classes)
        self.converter.fit_corpus(manifest)
        self.dc = DeviceBatchCache(self.converter, manifest, self.device)
        o = self.config["optimizer"]
        self.tx = build_optimizer(name=o["name"], lr=o["lr"], eps=o["eps"],
                                  weight_decay=o["weight_decay"],
                                  grad_clip=self.mix["grad_clip"])
        names, params = zip(*model.named_parameters())
        self.names = names
        self.ts = TrainState(model, self.tx.init(params, names), 0, self.tx)
        self.make_step()
        self.uploader = BatchUploader(self.device)

    def make_model(self, mc):
        """The trained model, its weights the seeded state."""
        from fcl_taco2_tpu_torch.models import Tacotron2SA
        model = Tacotron2SA(mc, device=self.device)
        self.sd = weights.seeded_state(model, self.seed, self.device,
                                       tag="model")
        model.load_state_dict(self.sd)
        return model

    def make_step(self):
        """The chained step, assembling its batches from the cache."""
        from fcl_taco2_tpu_torch.train.step import make_chained_train_step
        self.chain = make_chained_train_step(self.tx,
                                             assemble=self.dc.assemble)

    def prepare(self, pack):
        self.chain.prepare(self.ts, pack, self.train_seed)

    def step(self, packs):
        """One dispatch of the uploaded (K, P) plan packs; returns the
        (K, n_keys) reports."""
        self.ts, rep = self.chain(self.ts, packs, self.train_seed)
        return rep

    def report_keys(self):
        return self.chain.report_keys

    def graphs(self):
        return self.chain.graphs

    def _packs(self, group):
        return np.stack([self.dc.plan([self.manifest[j] for j in b])
                         for b in group])

    def _dispatch(self, group):
        return self.step(self.uploader(self._packs(group)))

    def warm(self):
        """Capture the step's graph, then the first three steps by the
        window's call: a chain of one and a chain of two."""
        self.prepare(self.uploader(self.dc.plan(
            [self.manifest[j] for j in self.batches[0]])))
        model = self.ts.model
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        rep1 = self._dispatch(self.batches[0:1])
        mu = dict(zip(self.names, self.ts.opt_state["mu"]))
        grad = _leaf_norms({k: v / (1 - B1) for k, v in mu.items()})
        rep23 = self._dispatch(self.batches[1:3])
        change = _leaf_norms({k: v.detach() - p0[k]
                              for k, v in model.named_parameters()})
        i = self.report_keys().index("loss")
        self.answers = {
            "loss": [float(r[i]) for r in torch.cat([rep1, rep23]).cpu()],
            "grad": grad, "change": change}
        self.next = 3
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- the window ----
    def _groups(self, n):
        """The next ``n`` dispatches' batch groups (wrapping round the
        drawn epochs)."""
        K = int(self.mix["chain"])
        out = []
        for _ in range(n):
            out.append([self.batches[(self.next + k) % len(self.batches)]
                        for k in range(K)])
            self.next += K
        return out

    def _facts(self, group):
        return [{"utts": [(len(self.utts[j].tokens), self.utts[j].frames)
                          for j in b]} for b in group]

    def window(self, run, seconds):
        from fcl_taco2_tpu_torch.data.loader import PrefetchLoader
        groups = self._groups(int(math.ceil(
            seconds * self.mix["max_steps_per_s"] / self.mix["chain"])) + 1)
        loader = PrefetchLoader(groups, self._packs, self.uploader)
        it = iter(loader)
        pending, reports = [], []
        self._sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        try:
            for group, packs in zip(groups, it):
                if time.perf_counter() >= end:
                    break
                pending.append(self.step(packs))
                run.attempted += len(group)
                run.calls.extend(self._facts(group))
                if len(pending) >= 8:  # the trainer's report flush
                    reports.append(torch.cat(pending).cpu())
                    pending = []
            else:
                raise RuntimeError("the window outlasted its batches: "
                                   "raise the mix's max_steps_per_s")
        finally:
            it.close()
        if pending:
            reports.append(torch.cat(pending).cpu())
        self._sync()
        run.window_s = time.perf_counter() - t0
        i = self.report_keys().index("loss")
        losses = torch.cat(reports)[:, i] if reports else torch.zeros(0)
        run.failed = int((~torch.isfinite(losses)).sum())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def trace(self, run):
        """Two short traced sub-windows of ``trace_dispatches`` dispatches:
        the card's activity alone, then the host's too."""
        n = int(self.mix["trace_dispatches"])
        groups = self._groups(n)
        packs = [self.uploader(self._packs(g)) for g in groups]

        def body(ps):
            def run_():
                for p in ps:
                    self.step(p)
            return run_

        dev, _, window = tracing.record(body(packs), host=False)
        more = [self.uploader(self._packs(g)) for g in self._groups(1)]
        dev_h, host, _ = tracing.record(body(more), host=True)
        run.traced = {"dev": dev, "window_s": window,
                      "calls": [f for g in groups for f in self._facts(g)],
                      "idle_gaps": tracing.idle_by_host(dev_h, host)}

    def free(self):
        del self.ts, self.dc, self.converter
        self.__dict__.pop("chain", None)
        self.__dict__.pop("train_step", None)
        self.tmp.cleanup()

    # ---- the check ----
    def _batch(self, b):
        """Batch ``b`` as the reference takes it, at the corpus-fit static
        shapes, with its classed plan."""
        utts = [self.utts[j] for j in b]
        feats = [self.feats[j] for j in b]
        T = ref_train.round_up(max(len(u.tokens) for u in self.utts), 8)
        L = ref_train.round_up(max(u.frames for u in self.utts), 64)
        B, odim = len(b), self.config["model"]["odim"]
        tokens = np.zeros((B, T), np.int64)
        durs = np.zeros((B, T), np.int64)
        mel = np.zeros((B, L, odim), np.float32)
        f0 = np.zeros((B, T, 1), np.float32)
        en = np.zeros((B, T, 1), np.float32)
        for i, (u, (m, d, p, e)) in enumerate(zip(utts, feats)):
            n = len(u.tokens)
            tokens[i, :n], durs[i, :n] = u.tokens, d
            mel[i, :len(m)], f0[i, :n], en[i, :n] = m, p, e
        classes, gather = ref_train.classed_plan(durs, self.class_durs,
                                                 self.caps, L)
        dev = self.device

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(dev)
        return {"tokens": t(tokens), "durations": t(durs), "mel": t(mel),
                "f0": t(f0), "energy": t(en),
                "ilens": t([len(u.tokens) for u in utts]),
                "olens": t([u.frames for u in utts]), "gather": t(gather),
                "classes": [[t(x) for x in c] + [D]
                            for c, D in zip(classes, self.class_durs)]}

    def follow(self, pr, half=False):
        """The reference's first three steps from the seeded state: each
        step's loss, the first step's gradient as the update saw it, and
        the change of the parameters after the three (leaf norms).
        ``half``: the losses' means over the first half of each batch
        alone (a fault the check must catch)."""
        from fcl_taco2_tpu_torch.models import ModelConfig
        mc = self.model_config()
        self.class_durs = ModelConfig(**mc).effective_duration_classes
        self.caps = ref_train.class_caps([u.durations for u in self.utts],
                                         self.class_durs,
                                         int(self.mix["batch"]))
        names = list(self.names)
        master = {k: self.sd[k].detach().clone().float() for k in names}
        state = {"t": 0, "mu": {k: torch.zeros_like(v)
                                for k, v in master.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in master.items()}}
        o = self.config["optimizer"]
        out = {"loss": []}
        for k in range(3):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(corpus.split_seed(self.train_seed, k))
            leaves = {n: v.clone().requires_grad_(True)
                      for n, v in master.items()}
            batch = self._batch(self.batches[k])
            rows = None
            if half:
                rows = torch.arange(len(self.batches[k]),
                                    device=self.device) \
                    < len(self.batches[k]) // 2
            loss = self.ref_loss(leaves, mc, batch, gen, pr, rows)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[n] for n in names], allow_unused=True)))
            grads = {n: torch.zeros_like(master[n]) if g is None else g
                     for n, g in grads.items()}
            seen = ref_train.adam_step(master, grads, state, o["lr"],
                                       o["eps"], self.mix["grad_clip"])
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = _leaf_norms(seen) if seen else \
                    {n: 0.0 for n in names}
        out["change"] = _leaf_norms({n: master[n] - self.sd[n].float()
                                     for n in names})
        return out

    def ref_loss(self, leaves, mc, batch, gen, pr, rows=None):
        return ref_train.loss_fn(leaves, mc, batch, gen, pr, rows)[0]

    def control_answers(self):
        return self.follow(Precision("control"))

    def fault_answers(self):
        """The answers of the reference put in the program's place with a
        fault planted: half of each batch left out of the means."""
        return {"half_batch": self.follow(Precision("stated"), half=True)}

    def check(self, answers=None):
        """``loss_gap``: the worst of the three steps' loss gaps over the
        reference's loss (``loss1_gap``.. each step's); ``grad_gap`` and ``change_gap``: the worst leaf's
        gap between the two norms over the larger of the reference leaf's
        norm and the median leaf's; leaves whose reference gradient is
        under a thousandth of the median leaf's (moved by round-off alone
        under Adam) are left out of ``change_gap``; ``*_med_gap`` are the
        median leaf's gaps, and ``look`` names each worst leaf."""
        got = answers or self.answers
        ref = self.follow(Precision("stated"))
        gaps = [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])]
        out = {"loss_gap": max(gaps)}
        out.update({f"loss{k + 1}_gap": g for k, g in enumerate(gaps)})
        g_med = float(np.median(list(ref["grad"].values())))
        moved = [n for n, v in ref["grad"].items() if v >= 1e-3 * g_med]
        self.look = {}
        for key, leaves in (("grad", list(ref["grad"])), ("change", moved)):
            r = ref[key]
            med = float(np.median([r[n] for n in leaves]))
            gap = {n: abs(got[key][n] - r[n]) / max(r[n], med)
                   for n in leaves}
            out[f"{key}_gap"] = max(gap.values())
            out[f"{key}_med_gap"] = float(np.median(list(gap.values())))
            self.look[f"{key}_worst_leaf"] = max(gap, key=gap.get)
        return out
