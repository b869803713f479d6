"""Formant-synthesized speech-like corpus generator; a copy of
``fcl_taco2_tpu/audio/synthcorpus.py`` (the same numpy draws in the same
order, so one seed writes byte-equal wavs and TextGrids in both packages).

Where LJSpeech cannot be had (hosts without network access), end-to-end
quality measurements (MCD of a converged teacher on a held-out shard,
BASELINE.md "MCD parity" row) run on a generated corpus with realistic
acoustic structure:

- a phone inventory with vowel formant targets (F1-F3 from standard
  tables), fricative noise spectra, nasals, and stops with closures+bursts
- voiced phones synthesized additively: harmonics of a time-varying pitch
  contour (per-utterance base + declination + vibrato + jitter), shaped by
  formant resonance envelopes
- unvoiced phones as FFT-shaped noise
- per-phone amplitude contours and 10 ms crossfades

The result exercises everything the real pipeline exercises: the YIN F0
tracker sees true pitch with octave traps, the duration/pitch/energy
predictors see phone-dependent targets, and the decoder must learn real
spectral structure.  Output layout matches what ``run_preprocess`` expects
(the reference's preprocess.py:263-305): ``root/wavs/*.wav`` +
``root/tg/*.TextGrid``.
"""

import os

import numpy as np

SR = 22050

# (F1, F2, F3) Hz — standard American English formant targets
VOWELS = {
    "IY": (270, 2290, 3010), "IH": (390, 1990, 2550),
    "EH": (530, 1840, 2480), "AE": (660, 1720, 2410),
    "AA": (730, 1090, 2440), "AO": (570, 840, 2410),
    "UH": (440, 1020, 2240), "UW": (300, 870, 2240),
    "AH": (640, 1190, 2390), "ER": (490, 1350, 1690),
}
NASALS = {"M": (250, 1000, 2200), "N": (250, 1700, 2600)}
# fricatives: (center_hz, bandwidth_hz, voiced)
FRICATIVES = {
    "S": (6000, 2500, False), "SH": (3500, 1800, False),
    "F": (4500, 3500, False), "HH": (1500, 1500, False),
    "Z": (6000, 2500, True), "V": (3500, 3000, True),
}
# stops: (burst_center_hz, voiced)
STOPS = {"P": (1200, False), "T": (4000, False), "K": (2200, False),
         "B": (1200, True), "D": (4000, True), "G": (2200, True)}
PHONES = (list(VOWELS) + list(NASALS) + list(FRICATIVES) + list(STOPS)
          + ["sil"])


def _shaped_noise(n, center, bw, rng):
    """White noise FFT-shaped by a gaussian band around ``center``."""
    x = rng.normal(size=n).astype(np.float64)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    gain = np.exp(-0.5 * ((freqs - center) / max(bw, 1.0)) ** 2)
    return np.fft.irfft(spec * gain, n)


def _voiced(n, f0_track, formants, rng, n_harm=40):
    """Additive harmonic synthesis with formant-envelope amplitudes."""
    t_phase = np.cumsum(2 * np.pi * f0_track / SR)
    out = np.zeros(n)
    bws = (90.0, 120.0, 160.0)
    mean_f0 = float(f0_track.mean())
    for k in range(1, n_harm + 1):
        fk = k * mean_f0
        if fk > SR / 2 - 200:
            break
        gain = 0.15  # spectral tilt floor
        for (F, bw) in zip(formants, bws):
            gain += np.exp(-0.5 * ((fk - F) / (2.2 * bw)) ** 2)
        out += (gain / k) * np.sin(k * t_phase)
    return out


def _phone_wave(phone, n, f0_track, rng):
    """Returns (wave, voiced_mask): the mask marks samples where harmonic
    excitation at ``f0_track`` is actually present — the per-sample
    ground truth the F0-tracker evaluation scores against
    (scripts/f0_groundtruth_eval.py)."""
    ones = np.ones(n, bool)
    zeros = np.zeros(n, bool)
    if phone == "sil":
        return rng.normal(size=n) * 1e-4, zeros
    if phone in VOWELS:
        return _voiced(n, f0_track, VOWELS[phone], rng), ones
    if phone in NASALS:
        return 0.5 * _voiced(n, f0_track, NASALS[phone], rng), ones
    if phone in FRICATIVES:
        center, bw, voiced = FRICATIVES[phone]
        x = 0.35 * _shaped_noise(n, center, bw, rng)
        if voiced:
            x += 0.5 * _voiced(n, f0_track, (300, 1400, 2500), rng)
        return x, (ones if voiced else zeros)
    if phone in STOPS:
        center, voiced = STOPS[phone]
        x = np.zeros(n)
        mask = zeros.copy()
        closure = int(0.6 * n)
        burst = _shaped_noise(n - closure, center, 1500, rng)
        env = np.exp(-np.arange(n - closure) / (0.012 * SR))
        x[closure:] = 0.6 * burst * env
        if voiced:
            x[:closure] += 0.15 * _voiced(closure, f0_track[:closure],
                                          (200, 1000, 2200), rng)
            mask[:closure] = True
        return x, mask
    raise ValueError(phone)


def _duration(phone, rng):
    if phone == "sil":
        return float(rng.uniform(0.06, 0.16))
    if phone in VOWELS:
        return float(rng.uniform(0.07, 0.22))
    if phone in STOPS:
        return float(rng.uniform(0.04, 0.10))
    return float(rng.uniform(0.05, 0.14))


def synth_utterance(rng, n_phones, return_truth=False):
    """Random phone string -> (wav float64, [(start, end, phone)]).

    With ``return_truth``, also returns the per-sample excitation F0
    track (Hz) and voicing mask the generator used — the analytic ground
    truth the YIN evaluation scores against."""
    content = [p for p in PHONES if p != "sil"]
    phones = ["sil"]
    while len(phones) < n_phones - 1:
        p = content[int(rng.integers(0, len(content)))]
        # speech-like alternation: avoid long obstruent runs
        if p not in VOWELS and phones[-1] not in VOWELS \
                and phones[-1] != "sil" and rng.random() < 0.7:
            p = list(VOWELS)[int(rng.integers(0, len(VOWELS)))]
        phones.append(p)
    phones.append("sil")

    durs = [_duration(p, rng) for p in phones]
    total = sum(durs)
    n_total = int(total * SR)
    # pitch contour: base + declination + vibrato + jitter
    base = float(rng.uniform(140, 230))
    t = np.arange(n_total) / SR
    f0 = base * (1.0 - 0.25 * t / total)  # declination
    f0 *= 1.0 + 0.02 * np.sin(2 * np.pi * 5.2 * t)  # vibrato
    f0 *= 1.0 + 0.008 * np.cumsum(rng.normal(size=n_total)) / np.sqrt(
        np.arange(1, n_total + 1))  # slow jitter walk

    wav = np.zeros(n_total)
    voiced = np.zeros(n_total, bool)
    segs = []
    xfade = int(0.010 * SR)
    pos = 0.0
    for phone, d in zip(phones, durs):
        a = int(pos * SR)
        b = min(int((pos + d) * SR), n_total)
        n = b - a
        if n <= 0:
            pos += d
            continue
        x, vmask = _phone_wave(phone, n, f0[a:b], rng)
        # amplitude contour: attack/decay + utterance-level loudness
        env = np.minimum(np.arange(n) / max(xfade, 1), 1.0)
        env *= np.minimum((n - np.arange(n)) / max(xfade, 1), 1.0)
        loud = 0.7 + 0.3 * np.sin(2 * np.pi * pos / max(total, 1e-6))
        wav[a:b] += x * env * loud
        voiced[a:b] |= vmask
        segs.append((round(pos, 4), round(pos + d, 4), phone))
        pos += d
    peak = np.abs(wav).max()
    wav = 0.6 * wav / max(peak, 1e-9)
    if return_truth:
        return wav, segs, f0, voiced
    return wav, segs


def write_textgrid(path, intervals, tier_name="phones"):
    """Praat long-format TextGrid (what MFA emits and
    audio/textgrid.py parses)."""
    xmax = intervals[-1][1]
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        "xmin = 0", f"xmax = {xmax}", "tiers? <exists>", "size = 1",
        "item []:", "    item [1]:", '        class = "IntervalTier"',
        f'        name = "{tier_name}"', "        xmin = 0",
        f"        xmax = {xmax}",
        f"        intervals: size = {len(intervals)}",
    ]
    for i, (a, b, t) in enumerate(intervals, 1):
        lines += [f"        intervals [{i}]:", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{t}"']
    with open(path, "w") as f:
        f.write("\n".join(lines))


def generate_corpus(root, n_utts=200, seed=0, min_phones=14, max_phones=40,
                    log=None):
    """Write ``root/wavs/*.wav`` + ``root/tg/*.TextGrid``; returns root."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    os.makedirs(os.path.join(root, "tg"), exist_ok=True)
    for i in range(n_utts):
        uttid = f"synth{i:04d}"
        n_ph = int(rng.integers(min_phones, max_phones + 1))
        wav, segs = synth_utterance(rng, n_ph)
        wavfile.write(os.path.join(root, "wavs", f"{uttid}.wav"), SR,
                      (wav * 32767).astype(np.int16))
        write_textgrid(os.path.join(root, "tg", f"{uttid}.TextGrid"), segs)
        if log and (i + 1) % 100 == 0:
            log(f"generated {i + 1}/{n_utts} utterances")
    return root
