"""A synthetic corpus a model can learn, written in the manifest layout
``data/manifest.py`` reads (npy features, one JSON manifest a split): each
token id has a fixed mel vector, repeated over its duration with small
noise, and a fixed f0 and energy.  Used to drive the trainer end to end
without a real dataset."""

import json
import os

import numpy as np


def write_learnable_corpus(root, n_train, n_valid, vocab=11, odim=8,
                           length=(3, 9), max_dur=6, mean_dur=None, seed=0,
                           nan_utt=None):
    """Write ``n_train + n_valid`` utterances under ``root``.

    Args:
        vocab, odim: token ids 1..vocab-1 and the mel width.
        length: tokens an utterance, drawn from ``[length[0], length[1])``.
        max_dur, mean_dur: frames a token, uniform on ``[1, max_dur]``, or
            Poisson(``mean_dur``) clipped to ``[1, max_dur]`` when given.
        nan_utt: index of a training utterance whose mel holds a NaN.
    Returns (train_json, valid_json).
    """
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, odim)).astype(np.float32)
    f0_of, en_of = rng.normal(size=vocab), rng.normal(size=vocab)
    feat = os.path.join(root, "feats")
    os.makedirs(feat, exist_ok=True)
    utts = {}
    for i in range(n_train + n_valid):
        T = int(rng.integers(*length))
        tok = rng.integers(1, vocab, T)
        if mean_dur is None:
            dur = rng.integers(1, max_dur + 1, T)
        else:
            dur = np.clip(rng.poisson(mean_dur, T), 1, max_dur)
        mel = np.repeat(table[tok], dur, axis=0) + 0.05 * rng.normal(
            size=(int(dur.sum()), odim))
        if i == nan_utt:
            mel[0, 0] = np.nan
        arrays = {"mel": mel.astype(np.float32), "dur": dur[:, None],
                  "f0": f0_of[tok][:, None].astype(np.float32),
                  "en": en_of[tok][:, None].astype(np.float32)}
        paths = {}
        for name, arr in arrays.items():
            paths[name] = os.path.join(feat, f"utt{i:03d}_{name}.npy")
            np.save(paths[name], arr)
        utts[f"utt{i:03d}"] = {
            "input": [{"name": f"input{j + 1}", "feat": paths[k],
                       "filetype": "npy", "shape": list(arrays[k].shape)}
                      for j, k in enumerate(("mel", "dur", "f0", "en"))],
            "output": [{"name": "target1", "shape": [T, vocab],
                        "tokenid": " ".join(str(t) for t in tok)}]}
    keys = sorted(utts)
    out = []
    for name, part in (("train", keys[:n_train]), ("valid", keys[n_train:])):
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump({"utts": {k: utts[k] for k in part}}, f)
        out.append(path)
    return tuple(out)
