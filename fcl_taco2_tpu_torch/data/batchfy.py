"""Static batch planning over manifest metadata (the port's copy of
``fcl_taco2_tpu/data/batchfy.py``).

Reimplements the reference's four batching strategies
(batchfy_fcl.py: seq :7, bin :88, frame :182, shuffle :291, driver
make_batchset :330) against our Utterance metadata.  The reference
works on espnet json dicts with a TTS input/output swap (:404-420); here the
model-facing convention is direct: text length = ``n_tokens``, mel length =
``n_frames``.

The headline configs use ``batch_sort_key: shuffle`` with batch-size 16
(conf/train_pytorch_tacotron2.sa.yaml:29-32); seq/bin/frame are provided for
parity.  ``min_batch_size`` keeps every data-parallel shard fed (the
reference uses it for DataParallel, tts.py:451).
"""

import random as pyrandom
from typing import List

from fcl_taco2_tpu_torch.data.manifest import Utterance


def batchfy_by_seq(utts, batch_size, max_length_in, max_length_out,
                   min_batch_size=1, shortest_first=False):
    """Length-adaptive batch sizes over utterances sorted by text length.

    Matches batchfy_fcl.py:7-86: the batch size shrinks by the factor
    1 + max(ilen//max_in, olen//max_out) for the longest element."""
    sorted_utts = sorted(utts, key=lambda u: u.n_tokens,
                         reverse=not shortest_first)
    batches = []
    start = 0
    while start < len(sorted_utts):
        u = sorted_utts[start]
        factor = max(u.n_tokens // max_length_in,
                     u.n_frames // max_length_out)
        bs = max(min_batch_size, int(batch_size / (1 + factor)))
        end = min(len(sorted_utts), start + bs)
        batches.append(sorted_utts[start:end])
        start = end
    if shortest_first:
        batches.reverse()
    return batches


def batchfy_by_bin(utts, batch_bins, n_tokens_dim=1, n_frames_dim=80,
                   min_batch_size=1, shortest_first=False):
    """Count-of-bins batching (batchfy_fcl.py:88-180): pack utterances until
    sum((ilen+1)*idim + (olen+1)*odim) exceeds batch_bins."""
    if batch_bins <= 0:
        raise ValueError(f"invalid batch_bins={batch_bins}")
    sorted_utts = sorted(utts, key=lambda u: u.n_tokens,
                         reverse=not shortest_first)
    batches = []
    cur, cur_bins = [], 0
    for u in sorted_utts:
        b = (u.n_tokens + 1) * n_tokens_dim + (u.n_frames + 1) * n_frames_dim
        if cur and cur_bins + b > batch_bins and len(cur) >= min_batch_size:
            batches.append(cur)
            cur, cur_bins = [], 0
        cur.append(u)
        cur_bins += b
    if cur:
        batches.append(cur)
    if shortest_first:
        batches.reverse()
    return batches


def batchfy_by_frame(utts, max_frames_in, max_frames_out, max_frames_inout,
                     min_batch_size=1, shortest_first=False):
    """Frame-budget batching (batchfy_fcl.py:182-288)."""
    if max_frames_in <= 0 and max_frames_out <= 0 and max_frames_inout <= 0:
        raise ValueError("at least one of max-frames-{in,out,inout} needed")
    sorted_utts = sorted(utts, key=lambda u: u.n_tokens,
                         reverse=not shortest_first)
    batches = []
    cur, fin, fout = [], 0, 0
    for u in sorted_utts:
        over = (
            (max_frames_in > 0 and fin + u.n_tokens > max_frames_in)
            or (max_frames_out > 0 and fout + u.n_frames > max_frames_out)
            or (max_frames_inout > 0
                and fin + fout + u.n_tokens + u.n_frames > max_frames_inout))
        if cur and over and len(cur) >= min_batch_size:
            batches.append(cur)
            cur, fin, fout = [], 0, 0
        cur.append(u)
        fin += u.n_tokens
        fout += u.n_frames
    if cur:
        batches.append(cur)
    if shortest_first:
        batches.reverse()
    return batches


def batchfy_shuffle(utts, batch_size, min_batch_size=1, seed=1):
    """Random chunking (batchfy_fcl.py:291-327); drops trailing batches
    smaller than min_batch_size."""
    utts = list(utts)
    pyrandom.Random(seed).shuffle(utts)
    batches = [utts[i:i + batch_size]
               for i in range(0, len(utts), batch_size)]
    return [b for b in batches if len(b) >= min_batch_size]


def make_batchset(utts: List[Utterance], batch_size=16, count="auto",
                  sort_key="shuffle", max_length_in=150, max_length_out=400,
                  batch_bins=0, batch_frames_in=0, batch_frames_out=0,
                  batch_frames_inout=0, min_batch_size=1, shortest_first=False,
                  num_batches=0, seed=1, odim=80):
    """Build the static list of minibatches (batchfy_fcl.py:330-516).

    count='auto' resolves to 'seq' unless bin/frame budgets are given,
    matching the reference's auto rule (:388-401). ``num_batches`` truncates
    for smoke runs (--minibatches, :507-509).
    """
    if count == "auto":
        if batch_bins > 0:
            count = "bin"
        elif batch_frames_in > 0 or batch_frames_out > 0 \
                or batch_frames_inout > 0:
            count = "frame"
        else:
            count = "seq"
    if sort_key == "shuffle":
        batches = batchfy_shuffle(utts, batch_size, min_batch_size, seed)
    elif count == "seq":
        batches = batchfy_by_seq(utts, batch_size, max_length_in,
                                 max_length_out, min_batch_size,
                                 shortest_first)
    elif count == "bin":
        batches = batchfy_by_bin(utts, batch_bins, 1, odim, min_batch_size,
                                 shortest_first)
    elif count == "frame":
        batches = batchfy_by_frame(utts, batch_frames_in, batch_frames_out,
                                   batch_frames_inout, min_batch_size,
                                   shortest_first)
    else:
        raise ValueError(f"unknown count mode {count!r}")
    if num_batches > 0:
        batches = batches[:num_batches]
    return batches
