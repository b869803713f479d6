"""Audio frontend: framing, STFT magnitude, log-mel, frame energy (port of
``fcl_taco2_tpu/ops/stft.py``).

Semantics, as the JAX package's (the reference's librosa/espnet chain):

- librosa-style STFT: periodic hann, ``center=True`` with reflect padding,
  ``n_frames = 1 + len(x) // hop``;
- log-mel: ``log10(max(1e-10, |S| @ mel_basis.T))`` with a slaney-normalized
  librosa mel filterbank (htk=False);
- energy: the per-frame L2 norm over frequency bins.

The filterbank and the window are built on the host in numpy (copied
as is); the per-sample work runs on the tensor's device: frames are a
``Tensor.unfold`` view, the FFT is ``torch.fft.rfft`` (cuFFT on the card,
pocketfft on the CPU), and the mel product runs at full fp32 (TF32 would
move log10-mel by ~1e-3).

The windowed FFT runs in float64 and its spectrum is rounded to complex64
before the magnitude, as librosa's ``stft`` computes it through numpy
(float64 window and FFT, complex64 result).  An fp32 FFT's rounding
noise sits ~5 orders below a frame's peak, which is where the top mel
bands of clean voiced speech lie: there log10-mel moved by ~1e-3 between
an fp32 FFT and an fp64 one on the CPU, and by 6e-3 between cuFFT and
pocketfft in fp32 (``chip_smoke.py``'s ``[preprocess]``, H100).
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length, dtype=np.float32):
    """Periodic hann (scipy get_window('hann', n, fftbins=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(dtype)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sr, n_fft, n_mels=80, fmin=80.0, fmax=7600.0):
    """librosa.filters.mel(htk=False, norm='slaney') reimplementation.
    Returns (n_mels, 1 + n_fft//2) float32."""
    if fmax is None:
        fmax = sr / 2
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def reflect_pad(x, pad):
    """librosa's ``center=True`` padding of the last axis of ``x`` (1-D or
    2-D).  ``pad`` must be shorter than the rows: numpy reflects again
    past the edge, ``torch.nn.functional.pad`` refuses."""
    if pad >= x.shape[-1]:
        raise ValueError(f"reflect padding of {pad} samples needs rows "
                         f"longer than {pad}; got {x.shape[-1]} samples")
    return F.pad(x.unsqueeze(0), (pad, pad), mode="reflect")[0]


def frame_signal(x, frame_length, hop, center=True):
    """(..., N) -> (..., T, frame_length), librosa centering semantics; a
    view of ``x`` (of its padded copy with ``center``)."""
    if center:
        x = reflect_pad(x, frame_length // 2)
    return x.unfold(-1, frame_length, hop)


def stft_window(n_fft=1024, win_length=None, device="cpu"):
    """librosa's fp64 Hann window, zero-padded to ``n_fft``, on
    ``device``."""
    win_length = win_length or n_fft
    win = hann_window(win_length, np.float64)
    if win_length < n_fft:  # librosa pads the window to n_fft
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    return torch.from_numpy(win).to(device)


def stft_mag(x, n_fft=1024, hop=256, win_length=None, center=True,
             window=None):
    """|STFT| with librosa conventions: (..., N) -> (..., T, 1+n_fft//2).

    T = 1 + len(x)//hop for center=True (espnet stft, preprocess.py:71).
    ``window``: ``stft_window``'s, already on ``x``'s device (a CUDA graph
    copies nothing from the host)."""
    if window is None:
        window = stft_window(n_fft, win_length, x.device)
    frames = frame_signal(x, n_fft, hop, center)
    spec = torch.fft.rfft(frames.double() * window, n=n_fft, dim=-1)
    return spec.to(torch.complex64).abs()


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 products at full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def mel_from_mag(mag, mel_basis, eps=1e-10):
    """log10(max(eps, |S| @ mel_basis.T)), the product at full fp32."""
    with full_fp32_matmul():
        mel = mag @ mel_basis.T
    return torch.log10(torch.clamp(mel, min=eps))


def energy_from_mag(mag):
    """Per-frame L2 norm over the frequency bins."""
    return torch.sqrt(torch.sum(mag * mag, dim=-1))


def logmel(x, sr=22050, n_fft=1024, hop=256, win_length=None, n_mels=80,
           fmin=80.0, fmax=7600.0, eps=1e-10, mel_basis=None, center=True):
    """log10-mel spectrogram, espnet logmelspectrogram parity:
    (..., N) -> (..., T, n_mels)."""
    if mel_basis is None:
        mel_basis = torch.from_numpy(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(x.device)
    return mel_from_mag(stft_mag(x, n_fft, hop, win_length, center=center),
                        mel_basis, eps)


def frame_energy(x, n_fft=1024, hop=256, win_length=None, center=True):
    """Per-frame L2 norm of |STFT| (preprocess.py:71-72):
    (..., N) -> (..., T)."""
    return energy_from_mag(stft_mag(x, n_fft, hop, win_length, center=center))
