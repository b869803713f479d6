#!/usr/bin/env python3
"""Generate the F0 torture-test goldens (the cases of
``tests/fixtures/f0_goldens.npz``) from the port's synthetic corpus
module (``audio/synthcorpus.py``).

Ground truth comes from analytic synthesis: every signal is built from a
known f0 contour, so the truth is exact rather than estimated.  The cases
target the failure modes where pitch trackers diverge on real speech:

  vibrato       modulated f0 (tracking lag / smearing)
  octave_trap   weak fundamental + dominant 2nd harmonic (octave-up errors)
  creaky_low    low f0 (75-95 Hz) with strong jitter and shimmer
  noisy         harmonics at 5 dB SNR white noise
  breathy       harmonics + strong high-frequency aspiration noise
  speechlike    formant-filtered vowels with silences (voicing boundaries)
  onsets        alternating tone bursts and silence (voicing F1)

Frame grid: hop 256 @ 22,050 Hz (the pipeline's mel grid).  Voiced truth
is 0 Hz in silence.

    python3 scripts/torch_make_f0_goldens.py [--out PATH]

``--out`` defaults to ``f0_goldens.npz`` in the temporary directory, so
the committed fixture is replaced only when ``--out`` names it.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SR = 22050
HOP = 256


def harmonics(f0_track, n_harm=12, amps=None, rng=None):
    """Additive synthesis from an instantaneous-f0 track."""
    phase = np.cumsum(2 * np.pi * f0_track / SR)
    x = np.zeros_like(f0_track)
    for k in range(1, n_harm + 1):
        a = amps[k - 1] if amps is not None else 1.0 / k
        x += a * np.sin(k * phase)
    return x


def frame_truth(f0_track, n):
    """Instantaneous truth -> per-frame truth at the mel grid (frame t
    covers samples around t*HOP; use the window-center value)."""
    T = 1 + n // HOP
    idx = np.minimum(np.arange(T) * HOP, n - 1)
    return f0_track[idx]


def make_cases(seed=0):
    rng = np.random.default_rng(seed)
    cases = {}

    def add(name, x, f0_truth):
        x = (x / max(np.abs(x).max(), 1e-9) * 0.5).astype(np.float32)
        cases[name] = (x, frame_truth(f0_truth, len(x)).astype(np.float32))

    n = 3 * SR
    t = np.arange(n) / SR

    # 1. vibrato: 180 Hz +-4% at 5.5 Hz
    f0 = 180.0 * (1 + 0.04 * np.sin(2 * np.pi * 5.5 * t))
    add("vibrato", harmonics(f0), f0)

    # 2. octave trap: fundamental at -22 dB vs 2nd harmonic
    f0 = np.full(n, 120.0)
    amps = np.array([0.08, 1.0, 0.5, 0.35, 0.25, 0.2, 0.15, 0.1, 0.08,
                     0.06, 0.05, 0.04])
    add("octave_trap", harmonics(f0, 12, amps), f0)

    # 3. creaky low: 75-95 Hz wander + heavy per-cycle jitter + shimmer
    base = 85 + 10 * np.sin(2 * np.pi * 0.7 * t)
    jitter = 1 + 0.04 * np.cumsum(rng.normal(size=n)) / np.sqrt(
        np.arange(1, n + 1))
    f0 = np.clip(base * jitter, 72, 110)
    x = harmonics(f0, 15)
    shimmer = 1 + 0.3 * np.sin(2 * np.pi * f0.mean() / 2 * t / SR * SR
                               * 0 + 2 * np.pi * 4.0 * t)
    add("creaky_low", x * shimmer, f0)

    # 4. noisy: 5 dB SNR
    f0 = 200 * (1 - 0.1 * t / t[-1])
    x = harmonics(f0)
    sig_rms = np.sqrt((x ** 2).mean())
    noise = rng.normal(size=n) * sig_rms / (10 ** (5 / 20))
    add("noisy", x + noise, f0)

    # 5. breathy: strong high-passed aspiration noise (3 dB SNR above 2 kHz)
    f0 = 160 * (1 + 0.02 * np.sin(2 * np.pi * 3.0 * t))
    x = harmonics(f0, 8)
    noise = rng.normal(size=n)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    spec *= freqs > 1800
    hp = np.fft.irfft(spec, n)
    hp *= np.sqrt((x ** 2).mean()) / max(np.sqrt((hp ** 2).mean()), 1e-9)
    add("breathy", x + 0.7 * hp, f0)

    # 6. speechlike: formant vowels with silences
    from fcl_taco2_tpu_torch.audio.synthcorpus import VOWELS, _voiced

    segs = [("sil", 0.25), ("AA", 0.5), ("IY", 0.4), ("sil", 0.3),
            ("UW", 0.5), ("EH", 0.45), ("sil", 0.25)]
    xs, f0s = [], []
    for phone, d in segs:
        m = int(d * SR)
        tt = np.arange(m) / SR
        if phone == "sil":
            xs.append(rng.normal(size=m) * 1e-4)
            f0s.append(np.zeros(m))
        else:
            f0 = 170 * (1 - 0.15 * tt / 3.0) * (
                1 + 0.015 * np.sin(2 * np.pi * 5.0 * tt))
            xs.append(_voiced(m, f0, VOWELS[phone], rng))
            f0s.append(f0)
    add("speechlike", np.concatenate(xs), np.concatenate(f0s))

    # 7. onsets: 120 ms bursts alternating with 120 ms silences
    xs, f0s = [], []
    for i in range(12):
        m = int(0.12 * SR)
        if i % 2 == 0:
            xs.append(np.zeros(m))
            f0s.append(np.zeros(m))
        else:
            f0 = np.full(m, 150.0 + 20 * (i % 3))
            xs.append(harmonics(f0, 8))
            f0s.append(f0)
    add("onsets", np.concatenate(xs), np.concatenate(f0s))

    return cases


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "f0_goldens.npz"))
    args = p.parse_args(argv)
    cases = make_cases()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    payload = {}
    for name, (x, truth) in cases.items():
        payload[f"{name}_signal"] = (x * 32767).astype(np.int16)
        payload[f"{name}_f0"] = truth
    np.savez_compressed(args.out, **payload)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"{len(cases)} cases)")


if __name__ == "__main__":
    main()
