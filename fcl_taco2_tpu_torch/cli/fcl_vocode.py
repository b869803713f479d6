#!/usr/bin/env python3
"""Vocode mel features (feats.scp from fcl_synth) to wavs with Parallel
WaveGAN; port of ``fcl_taco2_tpu/cli/fcl_vocode.py`` with the same flags,
plus ``--device``.

    python -m fcl_taco2_tpu_torch.cli.fcl_vocode --feats-scp OUT/feats.scp \
        --outdir WAVS [--checkpoint PWG.pkl] [--device cpu]

On the card each utterance is one launch of the streaming PWG kernel
(``vocoder/pwg_cuda.py``); on the CPU the exact chunked conv graph runs.
Without ``--checkpoint`` the vocoder has seeded random weights (smoke runs
only).  Raises when no card is present unless ``--device cpu`` is given.
"""

import argparse
import os
import wave as wavemod

import numpy as np

FRAME_BUCKET = 64  # mel lengths are padded to a multiple of this


def write_wav(path, x, sr):
    x = np.clip(x, -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    with wavemod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def vocode_utterance(pwg, cfg, mel, noise, backend="auto", packed=None):
    """One utterance's mel (T, aux) -> wav (T * hop,) fp32 numpy
    (``fcl_vocode.py:66-79``): the mel is zero-padded to a multiple of
    ``FRAME_BUCKET`` frames (Tb), vocoded with ``noise`` (>= Tb * hop
    samples, a tensor or array), and the wav trimmed to T * hop."""
    import torch

    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import vocode

    dev = pwg.device
    T = mel.shape[0]
    Tb = -(-T // FRAME_BUCKET) * FRAME_BUCKET
    mel_p = torch.zeros(1, Tb, mel.shape[1], device=dev)
    mel_p[0, :T] = torch.as_tensor(np.asarray(mel, np.float32), device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    noise = noise.reshape(-1)[:Tb * cfg.hop][None]
    wav = vocode(pwg, cfg, mel_p, noise, backend=backend, packed=packed)
    return wav[0, :T * cfg.hop].cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats-scp", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="official ParallelWaveGAN .pkl (random init if "
                        "omitted; for smoke runs only)")
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=["auto", "pallas", "xla"],
                   default="auto",
                   help="auto = the streaming PWG kernel on the card, the "
                        "exact chunked conv graph on the CPU; pallas = the "
                        "kernel (its plain version on the CPU); xla = the "
                        "chunked conv graph")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda, which must be "
                        "present; cpu runs the plain PyTorch versions)")
    args = p.parse_args(argv)

    import torch

    from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 load_pwg_checkpoint)
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import pack_pwg_weights

    cfg = PWGConfig()
    if args.checkpoint:
        pwg = load_pwg_checkpoint(args.checkpoint, cfg, device=args.device)
    else:
        print("WARNING: no --checkpoint; using random weights (noise out)")
        pwg = ParallelWaveGAN(cfg, device=args.device, seed=args.seed)
    packed = pack_pwg_weights(pwg, cfg)  # once, for every utterance
    gen = torch.Generator(device=pwg.device)
    gen.manual_seed(args.seed)

    os.makedirs(args.outdir, exist_ok=True)
    with open(args.feats_scp) as f:
        entries = [line.split() for line in f.read().splitlines()]
    for uttid, pointer in entries:
        mel = read_ark_matrix(pointer)
        Tb = -(-mel.shape[0] // FRAME_BUCKET) * FRAME_BUCKET
        noise = torch.randn(Tb * cfg.hop, generator=gen, device=pwg.device)
        wav = vocode_utterance(pwg, cfg, mel, noise, backend=args.backend,
                               packed=packed)
        write_wav(os.path.join(args.outdir, f"{uttid}.wav"), wav,
                  args.sample_rate)
    print(f"vocoded {len(entries)} utts -> {args.outdir}")
    return len(entries)


if __name__ == "__main__":
    main()
