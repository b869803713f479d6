"""Phoneme <-> utterance frame regrouping (port of
``fcl_taco2_tpu/ops/regroup.py``).

The host builds small int32 index plans with vectorized numpy, exactly as
the JAX package does (the plan builders below are its numpy code); the
device does the gathers:

- ``gather_segments``: (B, Lmax, C) utterance-major -> (P, D, C)
  phoneme-major (the decoder's teacher-forcing targets);
- ``scatter_frames`` / ``scatter_frames_classed``: (P, D, C)
  phoneme-major -> (B, Lmax, C) utterance-major (the decoder outputs,
  before the postnet).

Zero-duration phonemes are dropped; segments are utterance-major then
token order, so the concatenated segments of an utterance are its frames
in order.

The backward of the gathers of ``gather_token_vectors`` and
``scatter_frames[_classed]`` is the span ``regroup.bwd``
(``utils/spans.py::backward_span``): on the card the kernel of
``ops/regroup_cuda.py``, a gather through the plan's inverse map, which
relies on the builders' padding: every padded position (a frame past its
utterance's length, a segment of no duration) aims at row 0 of what it
reads; on the CPU autograd's own indexing backward.
"""

from typing import NamedTuple

import numpy as np
import torch

from fcl_taco2_tpu_torch.ops.regroup_cuda import RegroupGather
from fcl_taco2_tpu_torch.utils.spans import backward_span


class RegroupPlan(NamedTuple):
    """Static-shape index plan for one batch. All host-built numpy int32."""

    seg_utt: np.ndarray      # (P,) utterance index of each segment (0 pad)
    seg_tok: np.ndarray      # (P,) token position within utterance (0 pad)
    seg_start: np.ndarray    # (P,) first frame of segment in utterance
    seg_dur: np.ndarray      # (P,) frames in segment (0 for pad segments)
    seg_mask: np.ndarray     # (P,) bool, True for real segments
    frame_mask: np.ndarray   # (P, D) bool, True where d < seg_dur
    position: np.ndarray     # (P, D) float32, d / dur (reference tts.py:258)
    utt_gather: np.ndarray   # (B, Lmax) flat index into (P*D) phoneme frames
    utt_mask: np.ndarray     # (B, Lmax) bool, True at valid output frames
    n_segments: int          # real (unpadded) segment count


def build_plan(durations, olens, max_dur, n_seg_padded, max_olen):
    """Build a RegroupPlan on the host.

    Args:
        durations: (B, Tmax) int array of per-token frame durations
            (0 beyond ilens and for zero-length tokens).
        olens: (B,) total frames per utterance (== durations.sum(1)).
        max_dur: D, static per-segment frame budget (reference caps at 50,
            preprocess.py:203).
        n_seg_padded: P, static segment-count bucket (>= #nonzero tokens).
        max_olen: Lmax, static utterance frame bucket.
    """
    durations = np.asarray(durations, dtype=np.int32)
    olens = np.asarray(olens, dtype=np.int32)
    B, Tmax = durations.shape

    utt_idx, tok_idx = np.nonzero(durations > 0)  # utterance-major order
    seg_dur_real = durations[utt_idx, tok_idx]
    n_seg = len(utt_idx)
    if n_seg > n_seg_padded:
        raise ValueError(
            f"segment bucket too small: {n_seg} segments > {n_seg_padded}")
    if seg_dur_real.size and int(seg_dur_real.max()) > max_dur:
        raise ValueError(
            f"duration {int(seg_dur_real.max())} exceeds max_dur={max_dur}")

    # start frame of each token within its utterance = exclusive cumsum of
    # durations along the token axis
    starts_all = np.cumsum(durations, axis=1) - durations
    seg_start_real = starts_all[utt_idx, tok_idx]

    P, D = n_seg_padded, max_dur
    seg_utt = np.zeros(P, np.int32)
    seg_tok = np.zeros(P, np.int32)
    seg_start = np.zeros(P, np.int32)
    seg_dur = np.zeros(P, np.int32)
    seg_utt[:n_seg] = utt_idx
    seg_tok[:n_seg] = tok_idx
    seg_start[:n_seg] = seg_start_real
    seg_dur[:n_seg] = seg_dur_real
    seg_mask = np.zeros(P, bool)
    seg_mask[:n_seg] = True

    d_range = np.arange(D, dtype=np.int32)[None, :]
    frame_mask = d_range < seg_dur[:, None]  # (P, D)
    # per-phoneme normalized position ramp: range(dur)/dur (tts.py:258)
    position = np.where(
        frame_mask, d_range / np.maximum(seg_dur[:, None], 1), 0.0
    ).astype(np.float32)

    # inverse map: utterance frame (b, l) -> flat phoneme frame p*D + d.
    # Frames of segment p land at rows seg_utt[p], cols seg_start[p]..+dur.
    utt_gather = np.zeros((B, max_olen), np.int32)
    total = int(seg_dur_real.sum())
    if total:
        seg_of_frame = np.repeat(np.arange(n_seg, dtype=np.int64),
                                 seg_dur_real)
        # offset within segment: arange over each run
        frame_off = (np.arange(total, dtype=np.int64)
                     - np.repeat(np.cumsum(seg_dur_real) - seg_dur_real,
                                 seg_dur_real))
        rows = utt_idx[seg_of_frame]
        cols = seg_start_real[seg_of_frame] + frame_off
        utt_gather[rows, cols] = (seg_of_frame * D + frame_off).astype(
            np.int32)
    utt_mask = (np.arange(max_olen, dtype=np.int32)[None, :]
                < olens[:, None])

    return RegroupPlan(seg_utt, seg_tok, seg_start, seg_dur, seg_mask,
                       frame_mask, position, utt_gather, utt_mask, n_seg)


class ClassPlan(NamedTuple):
    """One duration class of a ClassedPlan: segments whose duration fits
    in ``dur_cap`` frames, padded to a static per-class capacity."""

    dur_cap: int             # D_c: scan length for this class
    seg_utt: np.ndarray      # (P_c,)
    seg_tok: np.ndarray      # (P_c,)
    seg_start: np.ndarray    # (P_c,)
    seg_dur: np.ndarray      # (P_c,)
    seg_mask: np.ndarray     # (P_c,) bool
    frame_mask: np.ndarray   # (P_c, D_c) bool
    position: np.ndarray     # (P_c, D_c) float32


class ClassedPlan(NamedTuple):
    """Duration-classed regroup plan (SURVEY hard part #1's dual
    bucketing): segments are partitioned by duration so the decoder scans
    each class only ``dur_cap`` steps instead of max_dur for everyone.
    With LJSpeech-like durations (mean ~8 frames vs the 50-frame cap,
    preprocess.py:203) the single-class plan wastes ~84% of its decoder
    steps on padding; classes cut total scan work 2.5-3x.

    ``utt_gather`` indexes into the CONCATENATION of the per-class flat
    frame buffers (class c's segment j frame d lives at
    offset_c + j * D_c + d, offset_c = sum of cap_i * D_i for i < c)."""

    classes: tuple           # tuple of ClassPlan
    utt_gather: np.ndarray   # (B, Lmax) int32 into the concatenated flats
    utt_mask: np.ndarray     # (B, Lmax) bool
    n_segments: int


def build_classed_plan(durations, olens, class_durs, class_caps, max_olen):
    """Build a duration-classed RegroupPlan on the host.

    Args:
        durations: (B, Tmax) int per-token frame durations.
        olens: (B,) total frames per utterance.
        class_durs: ascending duration caps, last >= durations.max()
            (e.g. (8, 16, 32, 50)); a segment joins the first class whose
            cap fits it, spilling to LONGER classes (zero-padded there)
            when its own is full.
        class_caps: static per-class segment capacities (same length).
        max_olen: Lmax, static utterance frame bucket.
    """
    durations = np.asarray(durations, dtype=np.int32)
    olens = np.asarray(olens, dtype=np.int32)
    B, _ = durations.shape
    class_durs = tuple(int(d) for d in class_durs)
    class_caps = tuple(int(c) for c in class_caps)
    if list(class_durs) != sorted(set(class_durs)):
        raise ValueError(f"class_durs must be strictly ascending, got "
                         f"{class_durs}")
    if len(class_caps) != len(class_durs):
        raise ValueError("class_caps/class_durs length mismatch")

    utt_idx, tok_idx = np.nonzero(durations > 0)  # utterance-major order
    seg_dur_real = durations[utt_idx, tok_idx]
    n_seg = len(utt_idx)
    if seg_dur_real.size and int(seg_dur_real.max()) > class_durs[-1]:
        raise ValueError(
            f"duration {int(seg_dur_real.max())} exceeds top class cap "
            f"{class_durs[-1]}")
    starts_all = np.cumsum(durations, axis=1) - durations
    seg_start_real = starts_all[utt_idx, tok_idx]

    # first class whose cap fits each segment; spill the LAST arrivals of
    # an over-full class upward (any longer class is semantically valid,
    # just more padding)
    base = np.searchsorted(np.asarray(class_durs), seg_dur_real, "left")
    order = np.arange(n_seg)
    members = []
    pool = []  # (order, global index) spilled upward
    for c in range(len(class_durs)):
        idx = order[base == c]
        if pool:
            idx = np.concatenate([np.asarray(pool, np.int64), idx])
            pool = []
        if len(idx) > class_caps[c]:
            idx, spill = idx[:class_caps[c]], idx[class_caps[c]:]
            pool = list(spill)
        members.append(np.sort(idx))  # keep utterance-major order
    if pool:
        raise ValueError(
            f"{len(pool)} segments overflow the duration-class capacities "
            f"{class_caps} (total segments {n_seg}); enlarge the caps "
            "(converter fit_corpus derives safe ones)")

    classes = []
    offsets = []
    off = 0
    for c, idx in enumerate(members):
        P_c, D_c = class_caps[c], class_durs[c]
        seg_utt = np.zeros(P_c, np.int32)
        seg_tok = np.zeros(P_c, np.int32)
        seg_start = np.zeros(P_c, np.int32)
        seg_dur = np.zeros(P_c, np.int32)
        k = len(idx)
        seg_utt[:k] = utt_idx[idx]
        seg_tok[:k] = tok_idx[idx]
        seg_start[:k] = seg_start_real[idx]
        seg_dur[:k] = seg_dur_real[idx]
        seg_mask = np.zeros(P_c, bool)
        seg_mask[:k] = True
        d_range = np.arange(D_c, dtype=np.int32)[None, :]
        frame_mask = d_range < seg_dur[:, None]
        position = np.where(
            frame_mask, d_range / np.maximum(seg_dur[:, None], 1), 0.0
        ).astype(np.float32)
        classes.append(ClassPlan(D_c, seg_utt, seg_tok, seg_start, seg_dur,
                                 seg_mask, frame_mask, position))
        offsets.append(off)
        off += P_c * D_c

    utt_gather = np.zeros((B, max_olen), np.int32)
    for c, idx in enumerate(members):
        k = len(idx)
        if not k:
            continue
        dur_c = seg_dur_real[idx]
        total = int(dur_c.sum())
        if not total:
            continue
        j_of_frame = np.repeat(np.arange(k, dtype=np.int64), dur_c)
        frame_off = (np.arange(total, dtype=np.int64)
                     - np.repeat(np.cumsum(dur_c) - dur_c, dur_c))
        rows = utt_idx[idx][j_of_frame]
        cols = seg_start_real[idx][j_of_frame] + frame_off
        utt_gather[rows, cols] = (offsets[c] + j_of_frame * class_durs[c]
                                  + frame_off).astype(np.int32)
    utt_mask = (np.arange(max_olen, dtype=np.int32)[None, :]
                < olens[:, None])
    return ClassedPlan(tuple(classes), utt_gather, utt_mask, n_seg)


def duration_class_caps(per_utt_durations, class_durs, batch_size,
                        cap_bucket=64):
    """Safe static per-class capacities for any batch of <= batch_size
    utterances: per class, the sum of the batch_size largest per-utterance
    counts of segments whose FIRST-fitting class it is (an upper bound on
    any batch's class population; spill can only move segments upward, and
    upward room is guaranteed by bounding every class independently, with
    the top class bounded by the total).

    Args:
        per_utt_durations: iterable of (T_i,) int arrays.
        class_durs: ascending duration caps (last >= all durations).
    """
    class_durs = tuple(int(d) for d in class_durs)
    edges = np.asarray(class_durs)
    counts = []
    for dur in per_utt_durations:
        dur = np.asarray(dur)
        dur = dur[dur > 0]
        base = np.searchsorted(edges, dur, "left")
        counts.append(np.bincount(base, minlength=len(class_durs)))
    counts = np.asarray(counts)  # (n_utts, n_classes)
    caps = []
    for c in range(len(class_durs)):
        top = np.sort(counts[:, c])[::-1][:batch_size]
        caps.append(int(np.ceil(max(int(top.sum()), 1) / cap_bucket))
                    * cap_bucket)
    return tuple(caps)


# ----- device-side gathers (plan fields arrive as tensors) -----

def _gather(x, valid, *indices):
    """``x[indices]``, whose backward is the span ``regroup.bwd``: where a
    gradient is taken on the card, ``RegroupGather``'s kernel (``valid``:
    the positions that are not padding), else plain indexing."""
    bs = backward_span("regroup.bwd")
    (x,) = bs.inputs(x)
    if bs.on and x.is_cuda:
        if valid is None:
            raise ValueError("a gradient through a regroup gather on the "
                             "card needs the positions' valid mask")
        out = RegroupGather.apply(x, valid, *indices)
    else:
        out = x[indices]
    return bs.outputs(out)[0]


def gather_token_vectors(hs, seg_utt, seg_tok, valid=None):
    """(B, Tmax, C) token vectors -> (P, C) per-segment encoder vectors
    (``regroup.py:290-295``).  ``valid`` (P,) bool, the segments of at
    least one frame (``frame_mask[:, 0]``), is needed for a gradient on
    the card."""
    return _gather(hs, valid, seg_utt, seg_tok)


def gather_segments(ys, seg_utt, seg_start, frame_mask):
    """(B, Lmax, C) frames -> (P, D, C) per-segment frames, zero padded
    (``regroup.py:298-307``)."""
    D = frame_mask.shape[1]
    d = torch.arange(D, dtype=seg_start.dtype, device=seg_start.device)
    cols = torch.clamp(seg_start[:, None] + d[None, :], max=ys.shape[1] - 1)
    out = ys[seg_utt[:, None], cols]  # (P, D, C)
    return out * frame_mask[..., None].to(ys.dtype)


def scatter_frames(seg_out, utt_gather, utt_mask):
    """(P, D, C) phoneme-major frames -> (B, Lmax, C) utterance-major
    (``regroup.py:310-319``)."""
    P, D, C = seg_out.shape
    out = _gather(seg_out.reshape(P * D, C), utt_mask,
                  utt_gather)  # (B, Lmax, C)
    return out * utt_mask[..., None].to(seg_out.dtype)


def scatter_frames_classed(seg_outs, utt_gather, utt_mask):
    """Duration-classed variant: per-class (P_c, D_c, C) frames ->
    (B, Lmax, C), gathering from the concatenation of the class flats
    (the layout ``ClassedPlan.utt_gather`` indexes; ``regroup.py:322-330``)."""
    C = seg_outs[0].shape[-1]
    flat = torch.cat([s.reshape(s.shape[0] * s.shape[1], C)
                      for s in seg_outs], dim=0)
    out = _gather(flat, utt_mask, utt_gather)
    return out * utt_mask[..., None].to(flat.dtype)
