"""F0 extraction with YIN (port of ``fcl_taco2_tpu/ops/f0.py``), batched
over rows: the JAX package ``vmap``s it per utterance
(``audio/preprocess.py:159``); here one call takes a (B, N) batch.

YIN (de Cheveigné & Kawahara 2002): the difference function through an
FFT cross-correlation, the cumulative-mean normalized difference (CMND),
the first lag below an absolute threshold (else the CMND's minimum),
a walk to the local minimum, parabolic interpolation, and a voicing
decision gated by the frame's energy.  Unvoiced frames are exact zeros.
The JAX docstring's error budget against ``tests/fixtures/f0_goldens.npz``
holds for this port too (``tests/test_torch_port_preprocess.py``).
"""

import numpy as np
import torch

from fcl_taco2_tpu_torch.ops.stft import frame_signal
from fcl_taco2_tpu_torch.utils.device import resolve_device


def yin_f0(x, sr=22050, hop=256, win_length=1024, fmin=71.0, fmax=800.0,
           threshold=0.35, device="cuda"):
    """x: (N,) or (B, N) float (numpy or tensor, moved to ``device``) ->
    f0 (T,) or (B, T) float32 on ``device``, 0 where unvoiced.

    T = 1 + N//hop (the STFT frame count, so phoneme averaging uses one
    frame grid, preprocess.py:66 trims f0 to the mel length).  Each row
    needs more than (win_length + sr/fmin)//2 samples (reflect padding).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    tau_max = int(sr / fmin)
    tau_min = max(int(sr / fmax), 1)
    W = win_length

    # frames long enough to evaluate lags up to tau_max: (..., T, W+tau_max)
    frames = frame_signal(x, W + tau_max, hop, center=True)

    # difference function d(tau) = r0[0] + r0[tau] - 2*corr(tau), through
    # an FFT cross-correlation
    n_fft = 1
    while n_fft < (W + tau_max):
        n_fft *= 2
    spec_full = torch.fft.rfft(frames, n=n_fft, dim=-1)
    spec_head = torch.fft.rfft(frames[..., :W], n=n_fft, dim=-1)
    corr = torch.fft.irfft(spec_full * torch.conj(spec_head), n=n_fft,
                           dim=-1)[..., :tau_max + 1]

    csum = torch.cumsum(frames * frames, dim=-1)
    e0 = csum[..., W - 1]  # energy of x[0:W]
    # energy of x[tau:tau+W] for each tau
    pad = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    taus = torch.arange(tau_max + 1, device=dev)
    e_tau = pad[..., taus + W] - pad[..., taus]
    d = e0[..., None] + e_tau - 2.0 * corr  # (..., T, tau_max+1)

    # cumulative-mean normalized difference
    cums = torch.cumsum(d[..., 1:], dim=-1)
    tau_idx = torch.arange(1, tau_max + 1, dtype=d.dtype, device=dev)
    cmnd = d[..., 1:] * tau_idx / torch.clamp(cums, min=1e-12)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)

    # first tau in [tau_min, tau_max] below threshold; fallback to argmin.
    # argmax of a bool is cast to uint8 first; both frameworks return the
    # first maximal (minimal) index.
    in_range = (taus >= tau_min) & (taus <= tau_max)
    below = (cmnd < threshold) & in_range
    any_below = below.any(dim=-1)
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)  # 0 if none
    masked = torch.where(in_range, cmnd, torch.full_like(cmnd, np.inf))
    best = torch.argmin(masked, dim=-1)
    tau = torch.where(any_below, first_below, best)

    # refine: from the first-below point, walk to the local minimum basin by
    # taking the argmin within a small window after tau
    offs = torch.arange(32, device=dev)
    local = torch.gather(
        cmnd, -1, torch.clamp(tau[..., None] + offs, 0, tau_max))
    tau = torch.clamp(tau + torch.argmin(local, dim=-1), tau_min, tau_max)

    # parabolic interpolation around tau
    t0 = torch.clamp(tau - 1, 0, tau_max)
    t2 = torch.clamp(tau + 1, 0, tau_max)
    y0 = torch.gather(cmnd, -1, t0[..., None])[..., 0]
    y1 = torch.gather(cmnd, -1, tau[..., None])[..., 0]
    y2 = torch.gather(cmnd, -1, t2[..., None])[..., 0]
    denom = y0 - 2 * y1 + y2
    # the denom == 0 guard keeps a NaN out of the untaken branch
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / safe,
                        torch.zeros_like(denom))
    tau_f = tau.to(torch.float32) + torch.clamp(shift, -1.0, 1.0)

    # energy gate: silent frames are unvoiced regardless of the CMND value
    # (an all-zero frame has d == 0 everywhere which would read as voiced)
    voiced = ((y1 < threshold) | any_below) & (e0 > 1e-6)
    f0 = torch.where(voiced, sr / torch.clamp(tau_f, min=1.0),
                     torch.zeros_like(tau_f))
    # frame count parity with the mel grid
    T = 1 + x.shape[-1] // hop
    return f0[..., :T].to(torch.float32)
