#!/usr/bin/env python3
"""Vocode mel features (feats.scp from fcl_synth) to wavs with Parallel
WaveGAN; port of ``fcl_taco2_tpu/cli/fcl_vocode.py`` with the same flags,
plus ``--device``.

    python -m fcl_taco2_tpu_torch.cli.fcl_vocode --feats-scp OUT/feats.scp \
        --outdir WAVS [--checkpoint PWG.pkl] [--device cpu]

On the card each utterance is one launch of the streaming PWG kernel
(``vocoder/pwg_cuda.py``), and its vocode (the noise draw, the upsampler
and the kernel) is one CUDA graph per ``FRAME_BUCKET`` length
(``BucketVocoder``), as JAX jits it per bucket (``fcl_vocode.py:60-79``);
on the CPU the exact chunked conv graph runs eagerly.  Without
``--checkpoint`` the vocoder has seeded random weights (smoke runs only).
Raises when no card is present unless ``--device cpu`` is given.
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


def _bucketed(mel):
    """(T, aux) mel -> (1, Tb, aux) fp32 numpy, zero-padded to a multiple
    ``Tb`` of ``FRAME_BUCKET`` frames (``fcl_vocode.py:66-70``)."""
    T = mel.shape[0]
    mel_p = np.zeros((1, -(-T // FRAME_BUCKET) * FRAME_BUCKET, mel.shape[1]),
                     np.float32)
    mel_p[0, :T] = mel
    return mel_p


def vocode_utterance(pwg, cfg, mel, noise, backend="auto", packed=None):
    """One utterance's mel (T, aux) -> wav (T * hop,) fp32 numpy
    (``fcl_vocode.py:66-79``): the mel is zero-padded to a multiple of
    ``FRAME_BUCKET`` frames (Tb), vocoded with ``noise`` (>= Tb * hop
    samples, a tensor or array), and the wav trimmed to T * hop."""
    import torch

    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import vocode

    dev = pwg.device
    mel_p = torch.from_numpy(_bucketed(mel)).to(dev)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    noise = noise.reshape(-1)[:mel_p.shape[1] * cfg.hop][None]
    wav = vocode(pwg, cfg, mel_p, noise, backend=backend, packed=packed)
    return wav[0, :mel.shape[0] * cfg.hop].cpu().numpy()


class BucketVocoder:
    """``vocode_utterance`` with the noise drawn from a generator: on the
    card one CUDA graph per padded length (``utils/graphs.py``), whose
    replay draws ``Tb * hop`` samples of noise from the caller's generator
    at its state, as the eager call draws them; eagerly on the CPU.
    ``graphed = False`` keeps the card eager."""

    def __init__(self, pwg, cfg, backend="auto", packed=None):
        from fcl_taco2_tpu_torch.utils.graphs import Graphed
        self.pwg, self.cfg = pwg, cfg
        self.backend, self.packed = backend, packed
        self.graphs = Graphed(self._body, pwg.device, "vocode")
        self.graphed = pwg.device.type == "cuda"

    def _body(self, mel_p, gen):
        import torch

        from fcl_taco2_tpu_torch.vocoder.pwg_cuda import vocode
        noise = torch.randn(mel_p.shape[1] * self.cfg.hop, generator=gen,
                            device=gen.device)
        return vocode(self.pwg, self.cfg, mel_p, noise[None],
                      backend=self.backend, packed=self.packed)

    def __call__(self, mel, gen):
        """(T, aux) mel -> (T * hop,) fp32 numpy wav, as
        ``vocode_utterance``."""
        import torch
        mel_p = torch.from_numpy(_bucketed(mel))
        if self.graphed:
            wav = self.graphs(None, mel_p, gen)
        else:
            wav = self._body(mel_p.to(self.pwg.device), gen)
        return wav[0, :mel.shape[0] * self.cfg.hop].cpu().numpy()


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
    # the operands packed once, for every utterance
    vocoder = BucketVocoder(pwg, cfg, backend=args.backend,
                            packed=pack_pwg_weights(pwg, cfg))
    gen = torch.Generator(device=pwg.device)
    gen.manual_seed(args.seed)

    os.makedirs(args.outdir, exist_ok=True)
    with open(args.feats_scp) as f:
        entries = [line.split() for line in f.read().splitlines()]
    for uttid, pointer in entries:
        wav = vocoder(read_ark_matrix(pointer), gen)
        write_wav(os.path.join(args.outdir, f"{uttid}.wav"), wav,
                  args.sample_rate)
    print(f"vocoded {len(entries)} utts -> {args.outdir}")
    return len(entries)


if __name__ == "__main__":
    main()
