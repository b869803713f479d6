"""The one generator of the benchmark's inputs: utterances shaped like
LJSpeech, made from a traffic file's ``corpus`` group and ``--seed``.

Lengths: the same multiset for every seed, ``set_size`` phoneme counts at
the quantiles (i + 0.5) / set_size of N(``phonemes_mean``,
``phonemes_sd``), rounded and clipped to [``phonemes_min``,
``phonemes_max``]; the seed draws the order (a fresh permutation of the set
for each pass over it).  The seed also draws each utterance's token ids,
uniform in [``vocab_min``, ``vocab_max``], its durations, Poisson
(``dur_mean``) frames a phoneme clipped to [``dur_min``, ``dur_max``],
and each call's generator seed (the decoder's dropout and the vocoder's
noise are drawn from it).  So runs with different seeds do the
same amount of work in another order, and one seed always gives the same
inputs.
"""

import statistics
from typing import List, NamedTuple

import numpy as np

_MASK64 = (1 << 64) - 1


def split_seed(base, *path):
    """A 63-bit seed mixed from ``base`` and ``path`` (ints or strings)
    with the splitmix64 finalizer: independent streams of one run seed."""
    z = int(base) & _MASK64
    for p in path:
        if isinstance(p, str):
            p = int.from_bytes(p.encode(), "little") & _MASK64
        z = (z + 0x9E3779B97F4A7C15 * (int(p) + 1)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


class Utterance(NamedTuple):
    tokens: np.ndarray     # (L,) int64, ids >= 1
    durations: np.ndarray  # (L,) int32 frames a phoneme

    @property
    def frames(self):
        return int(self.durations.sum())


def length_set(c):
    """The corpus's phoneme counts, one per quantile (sorted)."""
    n = int(c["set_size"])
    nd = statistics.NormalDist(c["phonemes_mean"], c["phonemes_sd"])
    return [int(min(max(round(nd.inv_cdf((i + 0.5) / n)),
                        c["phonemes_min"]), c["phonemes_max"]))
            for i in range(n)]


def utterances(c, seed, n) -> List[Utterance]:
    """``n`` utterances of corpus group ``c`` drawn from ``seed``.  A
    group with ``sizes_seed`` (a training corpus: a data set) draws every
    utterance's length and durations from that seed alone, and ``seed``
    draws their order and token ids: every run seed then trains on the
    same sizes, so the corpus-fit shapes, and the work a step, are the
    same."""
    if "sizes_seed" in c:
        sized = _draw({k: v for k, v in c.items() if k != "sizes_seed"},
                      c["sizes_seed"], n)
        rng = np.random.default_rng(split_seed(seed, "corpus order"))
        return [Utterance(rng.integers(c["vocab_min"], c["vocab_max"] + 1,
                                       len(sized[i].tokens)).astype(
                              np.int64), sized[i].durations)
                for i in rng.permutation(n)]
    return _draw(c, seed, n)


def _draw(c, seed, n):
    rng = np.random.default_rng(split_seed(seed, "corpus"))
    lengths = np.asarray(length_set(c))
    order = []
    while len(order) < n:
        order.extend(lengths[rng.permutation(len(lengths))])
    out = []
    for L in order[:n]:
        tokens = rng.integers(c["vocab_min"], c["vocab_max"] + 1,
                              L).astype(np.int64)
        dur = np.clip(rng.poisson(c["dur_mean"], L), c["dur_min"],
                      c["dur_max"]).astype(np.int32)
        out.append(Utterance(tokens, dur))
    return out


def calls(mix, seed):
    """The mix's requests: ``mix["calls"]`` lists of ``mix["batch"]``
    utterances, and a seed for each call's generator."""
    B, n = int(mix["batch"]), int(mix["calls"])
    utts = utterances(mix["corpus"], seed, B * n)
    rng = np.random.default_rng(split_seed(seed, "calls"))
    return [(utts[i * B:(i + 1) * B], int(rng.integers(0, 2 ** 62)))
            for i in range(n)]
