"""A tiny configuration and mix for running the harness on the CPU: the
student's topology at small widths, prenet dropout 0 (the CPU path of the
decoder draws its dropout from torch's generator, not the kernel's
Philox), a three-layer vocoder with hop 4, utterances of 12-20
phonemes."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def config(name="fcl-taco2-S", compute=None):
    """The configuration's groups at tiny widths; ``compute`` ("float32")
    puts every part in that type, so the program's CPU path and the
    reference agree to rounding."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        c = json.load(f)
    m = dict(c["model"])
    m.update(embed_dim=16, eunits=16, econv_chans=16, dunits=32,
             prenet_units=16, postnet_chans=16, duration_predictor_chans=16,
             pitch_predictor_chans=16, energy_predictor_chans=16,
             dropout_rate=0.0, max_dur=50)
    out = {"model": m}
    if compute:
        m["compute_dtype"] = compute
        out["precision"] = dict(c["precision"], compute_dtype=compute,
                                decoder_loop=compute)
    if "vocoder" in c:
        out["vocoder"] = dict(c["vocoder"], layers=3, stacks=3,
                              residual_channels=8, gate_channels=16,
                              skip_channels=8, upsample_scales=[2, 2])
    return out


def mix(**kw):
    corpus = {"phonemes_mean": 16, "phonemes_sd": 3, "phonemes_min": 12,
              "phonemes_max": 20, "set_size": 8, "vocab_min": 1,
              "vocab_max": 69, "dur_mean": 4, "dur_min": 1, "dur_max": 10}
    return dict({"corpus": corpus, "calls": 6, "sample": 2}, **kw)
