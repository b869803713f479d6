"""Batch converter: utterance features -> static-bucketed ``Batch`` of
numpy arrays (port of ``fcl_taco2_tpu/data/converter.py``; the same arrays
as the JAX converter).

The reference converter (tts.py:215-306) pads to the exact per-batch max
and slices mels per phoneme in Python.  Here every axis is rounded up to a
bucket (Tmax->x8, Lmax->x64, segments->x64), or fixed for the whole run
(``fit_corpus``), and the per-phoneme work is an int32 index plan
(``ops/regroup.build_plan``) consumed by device gathers.  The batch
dimension is padded to a fixed size with empty utterances (ilens=0).
The plans come from the native C++ builder (``data/native.py``,
bit-equal to the numpy builders, which stand in only where no C++
compiler exists).
"""

import math
from typing import List, Optional

import numpy as np

from fcl_taco2_tpu_torch.data.manifest import (Utterance, load_durations,
                                               load_features, load_spemb)
from fcl_taco2_tpu_torch.models.taco2_sa import Batch, SegClass
from fcl_taco2_tpu_torch.ops.regroup import (build_classed_plan,
                                             build_plan, duration_class_caps)


def _round_up(x, mult):
    return int(math.ceil(max(x, 1) / mult) * mult)


class BatchConverter:
    """Callable turning a list of Utterances into a Batch of numpy arrays."""

    def __init__(self, max_dur=50, batch_size: Optional[int] = None,
                 tok_bucket=8, frame_bucket=64, seg_bucket=64,
                 odim=80, cache=None, fixed_tmax: Optional[int] = None,
                 fixed_lmax: Optional[int] = None,
                 fixed_nseg: Optional[int] = None,
                 transform=None, transform_train: bool = False,
                 duration_classes=(), class_caps=None):
        """With ``fixed_*`` set, every batch gets the SAME shape.  Use
        ``fit_corpus`` to derive caps.

        ``transform``: optional callable ``transform(mel, train=...)``,
        e.g. ``data.transform.Transformation``, applied to each utterance's mel after loading (reference
        --preprocess-conf, io_utils_fcl.py:58-66); ``transform_train`` is
        its mode flag (tts.py:486-498).  Applied AFTER the cache so
        stochastic (train-only) ops re-draw every epoch.
        """
        self.max_dur = max_dur
        self.batch_size = batch_size
        self.tok_bucket = tok_bucket
        self.frame_bucket = frame_bucket
        self.seg_bucket = seg_bucket
        self.odim = odim
        self.cache = cache  # optional dict uttid -> features
        self.fixed_tmax = fixed_tmax
        self.fixed_lmax = fixed_lmax
        self.fixed_nseg = fixed_nseg
        self.transform = transform
        self.transform_train = transform_train
        # duration-classed plans (cfg.duration_classes, already normalized
        # to end at max_dur via cfg.effective_duration_classes): per-class
        # caps are either fixed (fit_corpus — one compile) or derived per
        # batch rounded to seg_bucket (bucketed compiles)
        self.duration_classes = tuple(int(d) for d in duration_classes)
        if (self.duration_classes
                and self.duration_classes[-1] != int(max_dur)):
            self.duration_classes += (int(max_dur),)
        self.class_caps = (None if class_caps is None
                           else tuple(int(c) for c in class_caps))

    def fit_corpus(self, utts):
        """Set fixed shapes from corpus metadata, valid for ANY batch of up
        to ``batch_size`` utterances: Tmax/Lmax are corpus maxima, the
        segment cap is the sum of the batch_size largest token counts."""
        if self.batch_size is None:
            raise ValueError("fit_corpus requires a fixed batch_size")
        tok_counts = sorted((u.n_tokens for u in utts), reverse=True)
        self.fixed_tmax = _round_up(tok_counts[0], self.tok_bucket)
        self.fixed_lmax = _round_up(max(u.n_frames for u in utts),
                                    self.frame_bucket)
        self.fixed_nseg = _round_up(sum(tok_counts[:self.batch_size]),
                                    self.seg_bucket)
        if self.duration_classes:
            # per-class capacity bound over ANY batch (durations are a
            # tiny per-utterance file — this scan is cheap)
            self.class_caps = duration_class_caps(
                (load_durations(u) for u in utts), self.duration_classes,
                self.batch_size, cap_bucket=self.seg_bucket)
        return self

    def _build_plan(self, durations, olens, n_seg_padded, max_olen):
        """The native plan builder where it is available, else
        ``ops/regroup.build_plan`` (``converter.py:95-99``)."""
        from fcl_taco2_tpu_torch.data.native import (build_plan_native,
                                                     native_available)
        if native_available():
            return build_plan_native(durations, olens, self.max_dur,
                                     n_seg_padded, max_olen)
        return build_plan(durations, olens, self.max_dur, n_seg_padded,
                          max_olen)

    def _build_classed_plan(self, durations, olens, caps, max_olen):
        """The native classed-plan builder where it is available, else
        ``ops/regroup.build_classed_plan``."""
        from fcl_taco2_tpu_torch.data.native import (
            build_classed_plan_native, native_available)
        if native_available():
            return build_classed_plan_native(
                durations, olens, self.duration_classes, caps, max_olen)
        return build_classed_plan(durations, olens, self.duration_classes,
                                  caps, max_olen)

    def _features(self, utt: Utterance):
        if self.cache is not None:
            if utt.uttid not in self.cache:
                self.cache[utt.uttid] = load_features(utt)
            feats = self.cache[utt.uttid]
        else:
            feats = load_features(utt)
        if self.transform is not None:
            mel, dur, f0, en = feats
            mel = self.transform(mel, train=self.transform_train)
            feats = (mel, dur, f0, en)
        return feats

    def __call__(self, utts: List[Utterance]) -> Batch:
        feats = [self._features(u) for u in utts]
        n = len(utts)
        B = self.batch_size or n
        if n > B:
            raise ValueError(f"batch of {n} exceeds configured size {B}")

        ilens = np.zeros(B, np.int32)
        olens = np.zeros(B, np.int32)
        for i, (u, (mel, dur, f0, en)) in enumerate(zip(utts, feats)):
            ilens[i] = u.n_tokens
            olens[i] = mel.shape[0]
        Tmax = self.fixed_tmax or _round_up(ilens.max(), self.tok_bucket)
        Lmax = self.fixed_lmax or _round_up(olens.max(), self.frame_bucket)
        if ilens.max() > Tmax or olens.max() > Lmax:
            raise ValueError(
                f"batch exceeds fixed shapes: tokens {int(ilens.max())}"
                f">{Tmax} or frames {int(olens.max())}>{Lmax}")

        tokens = np.zeros((B, Tmax), np.int32)
        durations = np.zeros((B, Tmax), np.int32)
        mel_arr = np.zeros((B, Lmax, self.odim), np.float32)
        f0_arr = np.zeros((B, Tmax, 1), np.float32)
        en_arr = np.zeros((B, Tmax, 1), np.float32)
        for i, (u, (mel, dur, f0, en)) in enumerate(zip(utts, feats)):
            T, L = u.n_tokens, mel.shape[0]
            tokens[i, :T] = u.tokenids
            # duration fix-up is preprocessing's job (preprocess.py:54);
            # enforce consistency here
            if int(dur.sum()) != L:
                raise ValueError(
                    f"{u.uttid}: durations sum {int(dur.sum())} != mel "
                    f"frames {L}")
            durations[i, :T] = dur
            mel_arr[i, :L] = mel
            f0_arr[i, :T] = f0
            en_arr[i, :T] = en

        # speaker embeddings (io_utils_fcl.py:330-336: spembs ride the batch
        # when the manifest has them); pad utterances get zero vectors
        spembs = None
        vecs = [load_spemb(u) for u in utts]
        if any(v is not None for v in vecs):
            dims = {v.shape[0] for v in vecs if v is not None}
            if len(dims) != 1 or any(v is None for v in vecs):
                raise ValueError(
                    "inconsistent speaker embeddings in batch: every "
                    f"utterance needs the same-dim spembs entry (got "
                    f"dims {sorted(dims)}, "
                    f"{sum(v is None for v in vecs)} missing)")
            spembs = np.zeros((B, dims.pop()), np.float32)
            for i, v in enumerate(vecs):
                spembs[i] = v

        common = dict(tokens=tokens, ilens=ilens, mel=mel_arr, olens=olens,
                      durations=durations, f0=f0_arr, energy=en_arr,
                      spembs=spembs)
        if self.duration_classes:
            caps = self.class_caps
            if caps is None:  # bucketed per-batch caps (no corpus fit)
                caps = duration_class_caps(
                    [durations[i, :ilens[i]] for i in range(n)],
                    self.duration_classes, n, cap_bucket=self.seg_bucket)
            plan = self._build_classed_plan(durations, olens, caps, Lmax)
            return Batch(
                seg_utt=None, seg_tok=None, seg_start=None, frame_mask=None,
                position=None, utt_gather=plan.utt_gather,
                utt_mask=plan.utt_mask,
                seg_classes=tuple(
                    SegClass(cp.seg_utt, cp.seg_tok, cp.seg_start,
                             cp.frame_mask, cp.position)
                    for cp in plan.classes),
                **common)

        n_seg = int((durations > 0).sum())
        n_seg_padded = self.fixed_nseg or _round_up(n_seg, self.seg_bucket)
        plan = self._build_plan(durations, olens, n_seg_padded, Lmax)
        return Batch(
            seg_utt=plan.seg_utt, seg_tok=plan.seg_tok,
            seg_start=plan.seg_start, frame_mask=plan.frame_mask,
            position=plan.position, utt_gather=plan.utt_gather,
            utt_mask=plan.utt_mask, **common)
