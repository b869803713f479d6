"""Offline preprocessing: MFA TextGrids + wavs -> features + manifests (port
of ``fcl_taco2_tpu/audio/preprocess.py``; the same files, names, dtypes,
shapes, JSON and split).

The reference's preprocess.py, rebuilt:
- vocab from TextGrid phone tiers, sorted, ids from 1, PAD=0 (:271-291)
- alignment: sample-accurate interval -> frame durations with the trailing
  silence merge rules (:165-196)
- features: log-mel (espnet parity), YIN F0 (pyworld replacement, zeros at
  unvoiced), per-frame energy, computed on the device by one batched call
  per length bucket (``Frontend``; the reference loops serially on the
  CPU, :299-304)
- duration fix-up: durations[-1] += mel_len - sum (:54)
- phoneme averaging of log-F0 (voiced frames only) and energy (:75-88)
- train-stats normalization: mel per-dim; f0 over voiced values only with
  zeros preserved; energy (:117-155)
- 500/500 val/test random split (:306-310), utterances with any phoneme
  duration > max_dur dropped from the manifests (:203)
- espnet-schema data.json output (:199-241) readable by data/manifest.py

Everything but ``Frontend`` is host numpy, copied from the JAX package.
"""

import collections
import dataclasses
import json
import math
import os
import random
import time
from glob import glob
from typing import Dict, List

import numpy as np
import torch

from fcl_taco2_tpu_torch.audio.textgrid import get_tier, read_textgrid
from fcl_taco2_tpu_torch.ops.f0 import yin_f0
from fcl_taco2_tpu_torch.ops.stft import (energy_from_mag, mel_filterbank,
                                          mel_from_mag, stft_mag, stft_window)
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.graphs import Graphed

SIL_PHONES = ("sil", "sp", "spn")


@dataclasses.dataclass
class PreprocessConfig:
    data_root: str = "/Dataset/LJSpeech-1.1"
    feature_root: str = "data"
    textgrid_root: str = "TextGrid"
    set_fs: int = 22050
    fmax: int = 7600
    fmin: int = 80
    n_mels: int = 80
    n_fft: int = 1024
    n_shift: int = 256
    win_length: int = 0  # 0 -> n_fft
    max_dur: int = 50
    n_val: int = 500
    n_test: int = 500
    seed: int = 1
    batch_frames: int = 2 ** 21  # samples per frontend batch
    device: str = "cuda"  # the frontend's device


# ----------------------------------------------------------------------
# wav IO (soundfile replacement, stdlib/scipy only)
# ----------------------------------------------------------------------

def read_wav(path):
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    peak = np.abs(x).max() if len(x) else 0.0
    if peak > 1.0:  # preprocess.py:34-36
        x = x / peak
    return x, sr


def resample(x, sr_from, sr_to):
    """Polyphase resample via scipy (resampy replacement,
    preprocess.py:37-39)."""
    if sr_from == sr_to:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr_from, sr_to)
    return resample_poly(x, sr_to // g, sr_from // g).astype(np.float32)


# ----------------------------------------------------------------------
# alignment
# ----------------------------------------------------------------------

def alignment_from_textgrid(path, sr, hop):
    """TextGrid -> (phones, durations) with the reference's silence-merge
    semantics (preprocess.py:165-196)."""
    tier = get_tier(read_textgrid(path), "phones")
    parts = [[int(iv.xmin * sr), int(iv.xmax * sr), iv.text]
             for iv in tier.intervals]
    if not parts:
        raise ValueError(f"empty phones tier in {path}")
    if parts[-1][2] in ("", "sp", "spn"):
        parts[-1][2] = "sil"
    if len(parts) >= 2 and parts[-2][2] in SIL_PHONES \
            and parts[-1][2] == "sil":
        parts[-2][2] = "sil"
        parts[-2][1] = parts[-1][1]
        parts = parts[:-1]
    phones = [p[2] for p in parts]
    durations = [p[1] // hop - p[0] // hop for p in parts]
    return phones, durations


def build_vocab(textgrid_paths) -> Dict[str, str]:
    """Sorted phone set -> ids from 1, PAD=0 (preprocess.py:277-291)."""
    phones = set()
    for p in textgrid_paths:
        tier = get_tier(read_textgrid(p), "phones")
        phones.update(iv.text for iv in tier.intervals)
    phn2idx = {p: str(i) for i, p in enumerate(sorted(phones), 1)}
    phn2idx["PAD"] = 0
    return phn2idx


# ----------------------------------------------------------------------
# frontend (device, batched)
# ----------------------------------------------------------------------

class Frontend:
    """Batched mel/F0/energy extraction on ``device`` with length
    bucketing (``preprocess.py:130-199`` of the JAX package, kept exactly:
    the same buckets, the same padding, hence the same tail frames).

    Each bucket is one upload (both row sets packed in one pinned host
    buffer), one call of the feature math and one readback (the three
    features packed in one device buffer, copied to pinned memory without
    a sync); the host prepares the next bucket while the device works, and
    at most two buckets are in flight.  On the card the feature math of a
    bucket shape ``(rows, samples)`` is one CUDA graph (``utils/graphs.py``;
    STFT, mel product, energy and YIN), as JAX jits it per bucket
    (``audio/preprocess.py:133-164``); ``graphed = False`` runs it eagerly.
    ``bucket_stats`` lists each bucket's rows, samples a row and, on the
    card, its device ms (CUDA events on the two sides of the replay, the
    upload into the graph's buffer included)."""

    def __init__(self, cfg: PreprocessConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.basis = torch.from_numpy(mel_filterbank(
            cfg.set_fs, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(
                self.device)
        self.window = stft_window(cfg.n_fft, cfg.win_length, self.device)
        self.bucket_stats = []
        self.graphs = Graphed(self._bucket, self.device, "frontend")
        self.graphed = self.device.type == "cuda"

    def features(self, x_stft, x_raw):
        """(R, L + n_fft) per-utterance reflect-padded rows and (R, L) raw
        rows -> mel (R, T, M), f0 (R, T), energy (R, T), T = 1 + L//hop.

        The STFT rows are reflect-padded by n_fft//2 per utterance BEFORE
        zero-bucketing, so every utterance's edge frames see the librosa
        center=True reflection of its own signal (zero-bucket padding
        would corrupt the last ~2 frames); the YIN rows are the
        zero-bucketed raw wavs, reflect-padded inside ``yin_f0``."""
        cfg = self.cfg
        mag = stft_mag(x_stft, cfg.n_fft, cfg.n_shift, window=self.window,
                       center=False)
        mel = mel_from_mag(mag, self.basis)
        en = energy_from_mag(mag)
        f0 = yin_f0(x_raw, cfg.set_fs, cfg.n_shift, device=self.device)
        return mel, f0, en

    def _bucket(self, inputs, gen):
        """One bucket's packed rows -> its packed features (R, T*M + 2T):
        the graph's body."""
        rows, R, max_len = inputs
        Ls = max_len + 2 * (self.cfg.n_fft // 2)
        mel, f0, en = self.features(rows[:R * Ls].view(R, Ls),
                                    rows[R * Ls:].view(R, max_len))
        return torch.cat([mel.reshape(R, -1), f0, en], dim=1)

    def _buckets(self, wavs):
        """Greedy length-bucketed batching: rows padded to the bucket's
        ``_round_up_pow2ish`` length, at most ``batch_frames`` samples."""
        order = np.argsort([len(w) for w in wavs])
        i = 0
        while i < len(order):
            max_len = 0
            chunk = []
            while i < len(order):
                w = wavs[order[i]]
                cand = max(max_len, _round_up_pow2ish(len(w)))
                if chunk and cand * (len(chunk) + 1) > self.cfg.batch_frames:
                    break
                max_len = cand
                chunk.append(order[i])
                i += 1
            yield chunk, max_len

    def _launch(self, wavs, chunk, max_len):
        """Host rows -> one upload, the features, one readback started."""
        cfg = self.cfg
        pad = cfg.n_fft // 2
        R, Ls = len(chunk), max_len + 2 * pad
        on_cuda = self.device.type == "cuda"
        host = torch.zeros(R * (Ls + max_len), dtype=torch.float32,
                           pin_memory=on_cuda)
        rows = host.numpy()
        batch_stft = rows[:R * Ls].reshape(R, Ls)
        batch_raw = rows[R * Ls:].reshape(R, max_len)
        for r, j in enumerate(chunk):
            w = wavs[j]
            batch_stft[r, :len(w) + 2 * pad] = np.pad(w, pad, mode="reflect")
            batch_raw[r, :len(w)] = w
        inputs = (host, R, max_len)
        if self.graphed:
            self.graphs.prepare(None, inputs)  # a new shape: capture first
        events = None
        if on_cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        if self.graphed:
            packed = self.graphs(None, inputs)
        else:
            packed = self._bucket(
                (host.to(self.device, non_blocking=True), R, max_len), None)
        if on_cuda:
            events[1].record()
        T = 1 + max_len // cfg.n_shift
        out = torch.empty(packed.shape, dtype=torch.float32,
                          pin_memory=on_cuda)
        if on_cuda:
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out.copy_(packed)
            done = None
        return {"chunk": chunk, "T": T, "out": out, "done": done,
                "events": events, "keep": host, "samples": max_len}

    def _finish(self, job, wavs, results):
        """Wait for a bucket's readback and slice out its utterances."""
        cfg = self.cfg
        if job["done"] is not None:
            job["done"].synchronize()
        T, M = job["T"], cfg.n_mels
        out = job["out"].numpy()
        for r, j in enumerate(job["chunk"]):
            n = 1 + len(wavs[j]) // cfg.n_shift
            row = out[r]
            results[j] = (np.array(row[:T * M].reshape(T, M)[:n]),
                          np.array(row[T * M:T * M + T][:n]),
                          np.array(row[T * M + T:][:n]))
        ev = job["events"]
        self.bucket_stats.append({
            "rows": len(job["chunk"]), "samples": job["samples"],
            "ms": ev[0].elapsed_time(ev[1]) if ev is not None else None})

    def process(self, wavs: List[np.ndarray]):
        """List of float32 wavs -> list of (mel (T,M), f0 (T,), en (T,))."""
        results = [None] * len(wavs)
        inflight = collections.deque()
        for chunk, max_len in self._buckets(wavs):
            inflight.append(self._launch(wavs, chunk, max_len))
            if len(inflight) > 1:
                self._finish(inflight.popleft(), wavs, results)
        while inflight:
            self._finish(inflight.popleft(), wavs, results)
        return results


def _round_up_pow2ish(n):
    """Round to the next {1, 1.25, 1.5, 1.75} * 2^k boundary (few buckets)."""
    if n <= 4096:
        return 4096
    k = 1 << (int(n - 1).bit_length() - 1)
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        if n <= k * frac:
            return int(k * frac)
    return 2 * k


# ----------------------------------------------------------------------
# phoneme averaging + normalization
# ----------------------------------------------------------------------

def phoneme_average(lf0, voiced, energy, durations):
    """Frame tracks -> per-phoneme averages (preprocess.py:75-88): log-F0
    averaged over voiced frames only (0 if none), energy over all frames."""
    ends = np.cumsum(durations)
    starts = ends - durations
    P = len(durations)
    f0_phn = np.zeros(P, np.float32)
    en_phn = np.zeros(P, np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        a, b = int(a), int(b)
        v = voiced[a:b]
        if v.any():
            f0_phn[i] = lf0[a:b][v].mean()
        if b > a:
            en_phn[i] = energy[a:b].mean()
    return f0_phn, en_phn


def compute_stats(mels, f0s, energies):
    """Train-split statistics (preprocess.py:117-137)."""
    all_mel = np.concatenate(mels, 0)
    all_f0 = np.concatenate([f[f != 0.0] for f in f0s], 0)
    all_en = np.concatenate(energies, 0)
    return {
        "mel_mean": all_mel.mean(0), "mel_std": all_mel.std(0),
        "f0_mean": float(all_f0.mean()) if len(all_f0) else 0.0,
        "f0_std": float(all_f0.std()) if len(all_f0) else 1.0,
        "en_mean": float(all_en.mean()), "en_std": float(all_en.std()),
    }


def normalize(mel, f0, en, stats, eps=1e-8):
    """(preprocess.py:139-146): zeros of f0 stay exactly zero."""
    mel = (mel - stats["mel_mean"]) / (stats["mel_std"] + eps)
    zero = f0 == 0.0
    f0 = (f0 - stats["f0_mean"]) / (stats["f0_std"] + eps)
    f0 = np.where(zero, 0.0, f0)
    en = (en - stats["en_mean"]) / (stats["en_std"] + eps)
    return mel.astype(np.float32), f0.astype(np.float32), \
        en.astype(np.float32)


# ----------------------------------------------------------------------
# the whole corpus
# ----------------------------------------------------------------------

class _Stages:
    """Logs each stage's name when it starts and its wall seconds when
    the next one starts (``done``)."""

    def __init__(self, log):
        self.log, self.name, self.t0 = log, None, 0.0

    def start(self, name, message):
        self.done()
        self.name, self.t0 = name, time.perf_counter()
        self.log(message)

    def done(self):
        if self.name is not None:
            self.log(f"  stage {self.name}: "
                     f"{time.perf_counter() - self.t0:.3f} s")
            self.name = None


def run_preprocess(cfg: PreprocessConfig, uttids=None, log=print):
    """The whole corpus -> ``cfg.feature_root`` (features, stats, vocab,
    manifests); returns (splits, stats).  Logs each stage's wall seconds
    (``stage <name>: <s> s``) and the frontend's per-bucket device ms."""
    os.makedirs(cfg.feature_root, exist_ok=True)
    tg_paths = sorted(glob(os.path.join(cfg.textgrid_root, "*.TextGrid")))
    if uttids is not None:
        keep = set(uttids)
        tg_paths = [p for p in tg_paths
                    if os.path.basename(p).split(".")[0] in keep]
    if not tg_paths:
        raise FileNotFoundError(f"no TextGrids in {cfg.textgrid_root}")
    frontend = Frontend(cfg, cfg.device)  # raises early without the device
    stages = _Stages(log)

    stages.start("vocab_alignment", f"vocab from {len(tg_paths)} "
                 "TextGrids, alignments...")
    phn2idx = build_vocab(tg_paths)
    with open(os.path.join(cfg.feature_root, "phn2idx.json"), "w") as f:
        json.dump(phn2idx, f, indent=4, sort_keys=True)
    utt_align = {}
    for p in tg_paths:
        uttid = os.path.basename(p).split(".")[0]
        phones, durs = alignment_from_textgrid(p, cfg.set_fs, cfg.n_shift)
        utt_align[uttid] = (phones, durs)

    stages.start("read_resample", "read + resample wavs...")
    ids = sorted(utt_align.keys())
    wavs = []
    for uttid in ids:
        wav_path = os.path.join(cfg.data_root, "wavs", f"{uttid}.wav")
        x, sr = read_wav(wav_path)
        x = resample(x, sr, cfg.set_fs)
        wavs.append(x)

    stages.start("frontend", f"frontend on {frontend.device}...")
    feats = frontend.process(wavs)
    ms = [s["ms"] for s in frontend.bucket_stats]
    log(f"  frontend: {len(ms)} buckets, "
        f"{sum(len(w) for w in wavs)} samples"
        + ("" if None in ms else
           ", device ms " + " ".join(f"{m:.3f}" for m in ms)))

    stages.start("normalize_save", "normalize + save features...")
    # pre-fix-up alignment durations artifact (preprocess.py:191-194
    # durations_MFA-ori: the raw TextGrid frame counts BEFORE the final
    # token absorbs the mel-length mismatch)
    ori_root = os.path.join(cfg.feature_root, "durations_MFA-ori")
    os.makedirs(ori_root, exist_ok=True)
    for uttid, (phones, durs) in utt_align.items():
        np.save(os.path.join(ori_root, f"{uttid}.npy"),
                np.asarray(durs, np.int64).reshape(-1, 1))

    utt_data = {}
    for uttid, (mel, f0, en) in zip(ids, feats):
        phones, durs = utt_align[uttid]
        durs = list(durs)
        durs[-1] += mel.shape[0] - sum(durs)  # preprocess.py:54
        if durs[-1] < 0:
            raise ValueError(f"{uttid}: durations exceed mel length")
        voiced = f0 != 0.0
        lf0 = np.where(voiced, np.log(np.maximum(f0, 1e-10)), 0.0)
        f0_phn, en_phn = phoneme_average(lf0, voiced, en,
                                         np.asarray(durs, np.int64))
        utt_data[uttid] = {"mel": mel, "f0": f0_phn, "en": en_phn,
                           "phones": phones, "durs": durs}

    rnd = random.Random(cfg.seed)
    val_test = set(rnd.sample(ids, min(cfg.n_val + cfg.n_test, len(ids))))
    val = set(rnd.sample(sorted(val_test),
                         min(cfg.n_val, len(val_test) // 2)))
    test = val_test - val
    train = [u for u in ids if u not in val_test]
    splits = {"train": train, "val": sorted(val), "test": sorted(test)}

    stats = compute_stats([utt_data[u]["mel"] for u in train],
                          [utt_data[u]["f0"] for u in train],
                          [utt_data[u]["en"] for u in train])
    np.save(os.path.join(cfg.feature_root, "mel_stats.npy"),
            np.stack([stats["mel_mean"], stats["mel_std"]]))
    np.save(os.path.join(cfg.feature_root, "f0_en_stats.npy"),
            np.asarray([stats["f0_mean"], stats["f0_std"],
                        stats["en_mean"], stats["en_std"]]))

    for sub in ("mels", "f0", "en", "durations_MFA"):
        os.makedirs(os.path.join(cfg.feature_root, sub), exist_ok=True)
    paths = {}
    for uttid, d in utt_data.items():
        mel, f0, en = normalize(d["mel"], d["f0"], d["en"], stats)
        p = {k: os.path.join(cfg.feature_root, sub, f"{uttid}.npy")
             for k, sub in [("mel", "mels"), ("f0", "f0"), ("en", "en"),
                            ("dur", "durations_MFA")]}
        np.save(p["mel"], mel)
        np.save(p["f0"], f0.reshape(-1, 1))
        np.save(p["en"], en.reshape(-1, 1))
        np.save(p["dur"], np.asarray(d["durs"], np.float64).reshape(-1, 1))
        paths[uttid] = p

    stages.start("manifests", "manifests...")
    n_phns = len(phn2idx)
    for mode, uids in splits.items():
        js = {}
        for uttid in uids:
            d = utt_data[uttid]
            if max(d["durs"]) > cfg.max_dur:  # preprocess.py:203
                continue
            p = paths[uttid]
            T = len(d["phones"])
            js[uttid] = {
                "input": [
                    {"feat": p["mel"], "filetype": "npy", "name": "input1",
                     "shape": [int(d["mel"].shape[0]), cfg.n_mels]},
                    {"feat": p["dur"], "filetype": "npy", "name": "input2",
                     "shape": [T, 1]},
                    {"feat": p["f0"], "filetype": "npy", "name": "input3",
                     "shape": [T, 1]},
                    {"feat": p["en"], "filetype": "npy", "name": "input4",
                     "shape": [T, 1]},
                ],
                "output": [{
                    "name": "target1", "shape": [T, n_phns],
                    "text": " ".join(d["phones"]),
                    "token": " ".join(d["phones"]),
                    "tokenid": " ".join(str(phn2idx[ph])
                                        for ph in d["phones"]),
                }],
                "utt2spk": "LJ",
            }
        out = os.path.join(cfg.feature_root, f"{mode}_data.json")
        with open(out, "w") as f:
            json.dump({"utts": js}, f, indent=4, sort_keys=True)
        log(f"  {mode}: {len(js)} utts -> {out}")
    stages.done()
    return splits, stats
