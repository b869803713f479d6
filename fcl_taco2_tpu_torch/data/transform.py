"""Configurable feature-transform chain for the loader (port of
``fcl_taco2_tpu/data/transform.py``: a host-side numpy copy, the same
draws for the same seed).

Reference parity: espnet's ``Transformation`` applied by the feature
loader when ``--preprocess-conf`` is given (io_utils_fcl.py:58-66,
tts.py:444-498 wiring train=True for the training iterators and
train=False for validation/decode).  The registry is first-party and
TTS-relevant: statistics normalization (``utterance_cmvn``,
``global_cmvn``/``cmvn``), ``gain``, and train-only SpecAugment-style
``freq_mask`` and ``time_mask``.  Conf schema matches espnet's:

    {"process": [{"type": "utterance_cmvn", "norm_vars": true},
                 {"type": "freq_mask", "F": 10, "n_mask": 1}]}

(json, or yaml where PyYAML is installed).  Each op maps (mel, train) ->
mel and must preserve the frame count: durations are aligned to mel
frames, so length-changing ops are rejected at apply time.
"""

import json
from typing import Optional

import numpy as np


def _utterance_cmvn(conf):
    norm_means = bool(conf.get("norm_means", True))
    norm_vars = bool(conf.get("norm_vars", False))
    eps = float(conf.get("eps", 1e-10))

    def apply(x, train, rng):
        if norm_means:
            x = x - x.mean(axis=0, keepdims=True)
        if norm_vars:
            x = x / np.maximum(x.std(axis=0, keepdims=True), eps)
        return x
    return apply


def _global_cmvn(conf):
    """Normalize with precomputed corpus stats (npy/npz with mean+std
    rows, e.g. preprocess.py's mel_stats.npy [mean; std])."""
    path = conf["stats"]
    norm_vars = bool(conf.get("norm_vars", True))
    eps = float(conf.get("eps", 1e-10))
    raw = np.load(path)
    if isinstance(raw, np.lib.npyio.NpzFile):
        mean, std = raw["mean"], raw["std"]
    else:
        mean, std = raw[0], raw[1]

    def apply(x, train, rng):
        x = x - mean[None, :]
        if norm_vars:
            x = x / np.maximum(std[None, :], eps)
        return x
    return apply


def _gain(conf):
    factor = float(conf.get("factor", 1.0))

    def apply(x, train, rng):
        return x * factor
    return apply


def _freq_mask(conf):
    """SpecAugment frequency masking; train-only, zero-width in eval."""
    F = int(conf.get("F", 10))
    n = int(conf.get("n_mask", 1))

    def apply(x, train, rng):
        if not train or F <= 0:
            return x
        x = x.copy()
        C = x.shape[1]
        for _ in range(n):
            w = int(rng.integers(0, F + 1))
            lo = int(rng.integers(0, max(C - w, 0) + 1))
            x[:, lo:lo + w] = 0.0
        return x
    return apply


def _time_mask(conf):
    """SpecAugment time masking (length-preserving; zeroed frames keep
    their duration alignment); train-only."""
    T = int(conf.get("T", 20))
    n = int(conf.get("n_mask", 1))

    def apply(x, train, rng):
        if not train or T <= 0:
            return x
        x = x.copy()
        L = x.shape[0]
        for _ in range(n):
            w = int(rng.integers(0, T + 1))
            lo = int(rng.integers(0, max(L - w, 0) + 1))
            x[lo:lo + w] = 0.0
        return x
    return apply


_REGISTRY = {
    "utterance_cmvn": _utterance_cmvn,
    "global_cmvn": _global_cmvn,
    "cmvn": _global_cmvn,          # espnet alias
    "gain": _gain,
    "freq_mask": _freq_mask,
    "time_mask": _time_mask,
}


class Transformation:
    """Chain of feature transforms from an espnet-schema conf.

    ``Transformation(path_or_dict)(mel, train=...)``; deterministic per
    (uttid, epoch) is the caller's concern — pass ``seed`` for
    reproducible stochastic ops.
    """

    def __init__(self, conf, seed: Optional[int] = 0):
        if isinstance(conf, str):
            with open(conf) as f:
                text = f.read()
            try:
                conf = json.loads(text)
            except json.JSONDecodeError:
                import yaml
                conf = yaml.safe_load(text)
        if not isinstance(conf, dict) or "process" not in conf:
            raise ValueError(
                "preprocess conf must be a dict with a 'process' list "
                "(espnet Transformation schema)")
        self.confs = list(conf["process"])
        self.ops = []
        for c in self.confs:
            kind = c.get("type")
            if kind not in _REGISTRY:
                raise ValueError(
                    f"unknown transform type {kind!r}; available: "
                    f"{sorted(_REGISTRY)}")
            self.ops.append(_REGISTRY[kind](c))
        self.rng = np.random.default_rng(seed)

    def __call__(self, mel, train: bool = False):
        L = mel.shape[0]
        x = np.asarray(mel, np.float32)
        for c, op in zip(self.confs, self.ops):
            x = op(x, train, self.rng)
            if x.shape[0] != L:
                raise ValueError(
                    f"transform {c.get('type')!r} changed the frame "
                    f"count {L} -> {x.shape[0]}; durations are aligned "
                    "to mel frames so transforms must preserve length")
        return x

    def __repr__(self):
        kinds = ", ".join(c.get("type", "?") for c in self.confs)
        return f"Transformation({kinds})"
