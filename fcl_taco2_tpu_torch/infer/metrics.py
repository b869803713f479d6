"""Objective evaluation metrics for synthesized mels (the port's own copy
of ``fcl_taco2_tpu/infer/metrics.py``, numpy + scipy).

- ``mel_cepstral_distortion``: MCD over mel-cepstra obtained by DCT-II of
  the log-mel frames (the standard 10/ln10 * sqrt(2 sum dc^2) formula,
  coefficients 1..K, c0 excluded), with DTW-free frame-wise alignment on
  equal-length sequences and trim-to-min otherwise.
- ``mel_l1`` / ``mel_rmse``: direct spectrogram distances.
"""

import math

import numpy as np
from scipy.fftpack import dct


def _to_cepstra(logmel, n_coef):
    return dct(logmel, type=2, axis=-1, norm="ortho")[..., :n_coef + 1]


def mel_cepstral_distortion(mel_a, mel_b, n_coef=13):
    """MCD in dB between two (T, n_mels) log-mel matrices."""
    T = min(len(mel_a), len(mel_b))
    ca = _to_cepstra(np.asarray(mel_a[:T]), n_coef)
    cb = _to_cepstra(np.asarray(mel_b[:T]), n_coef)
    diff = ca[:, 1:] - cb[:, 1:]  # exclude c0 (overall energy)
    dist = np.sqrt(2.0 * np.sum(diff * diff, axis=-1))
    return float(10.0 / math.log(10.0) * dist.mean())


def mel_l1(mel_a, mel_b):
    T = min(len(mel_a), len(mel_b))
    return float(np.abs(np.asarray(mel_a[:T]) - np.asarray(mel_b[:T]))
                 .mean())


def mel_rmse(mel_a, mel_b):
    T = min(len(mel_a), len(mel_b))
    d = np.asarray(mel_a[:T]) - np.asarray(mel_b[:T])
    return float(np.sqrt((d * d).mean()))
