"""The corpus generator: deterministic by seed, the same lengths for
every seed in another order, and the stated distributions."""

import json
import os

import numpy as np

from benchmark import corpus

HERE = os.path.dirname(os.path.abspath(__file__))


def _mix(name):
    with open(os.path.join(HERE, "..", "traffic", name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_inputs():
    mix = _mix("synth_b16")
    a, b = corpus.calls(mix, 2 ** 33 + 7), corpus.calls(mix, 2 ** 33 + 7)
    assert [s for _, s in a] == [s for _, s in b]
    for (ua, _), (ub, _) in zip(a, b):
        for x, y in zip(ua, ub):
            assert np.array_equal(x.tokens, y.tokens)
            assert np.array_equal(x.durations, y.durations)


def test_seeds_share_the_lengths_in_another_order():
    c = _mix("tts_b1")["corpus"]
    n = c["set_size"] * 3
    a = [len(u.tokens) for u in corpus.utterances(c, 1, n)]
    b = [len(u.tokens) for u in corpus.utterances(c, 2, n)]
    assert sorted(a) == sorted(b) and a != b
    # every pass over the set holds each length once
    assert sorted(a[:c["set_size"]]) == corpus.length_set(c)


def test_stated_distributions():
    c = _mix("synth_b16")["corpus"]
    lengths = np.array(corpus.length_set(c))
    assert lengths.min() >= 12 and lengths.max() <= 112
    assert abs(lengths.mean() - 71) < 1.0
    assert abs(lengths.std() - 22) < 1.5
    utts = corpus.utterances(c, 99, 512)
    d = np.concatenate([u.durations for u in utts])
    t = np.concatenate([u.tokens for u in utts])
    assert d.min() >= 1 and d.max() <= 50 and abs(d.mean() - 8) < 0.1
    assert abs(d.var() - 8) < 0.5  # Poisson: variance = mean
    assert t.min() >= 1 and t.max() <= 69
    frames = np.array([u.frames for u in utts]) / 86.13  # seconds
    assert 0.9 < frames.min() and frames.max() < 11.5
    assert abs(frames.mean() - 6.6) < 0.3  # LJSpeech's mean clip 6.57 s


def test_split_seed_streams_differ_and_fit_63_bits():
    s = {corpus.split_seed(2 ** 31 + 5, tag) for tag in
         ("corpus", "calls", "sample", "model", "vocoder")}
    assert len(s) == 5 and all(0 <= v < 2 ** 63 for v in s)


def test_a_training_corpus_has_the_same_sizes_for_every_seed():
    c = _mix("train_b64")["corpus"]
    a, b = corpus.utterances(c, 1, 256), corpus.utterances(c, 2 ** 33, 256)

    def sizes(utts):
        return sorted((len(u.tokens), tuple(u.durations)) for u in utts)
    assert sizes(a) == sizes(b)
    assert [len(u.tokens) for u in a] != [len(u.tokens) for u in b]
    assert not all(np.array_equal(x.tokens, y.tokens) for x, y in zip(
        sorted(a, key=lambda u: tuple(u.durations)),
        sorted(b, key=lambda u: tuple(u.durations))))
