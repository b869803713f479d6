"""Length masks and the masked / weighted loss reductions (port of
``fcl_taco2_tpu/ops/masking.py``).

On a rank of a data-parallel run (``parallel/``) a loss sees only its
share of the global batch; the reductions then take the global batch's
counts (``global_counts``, carried by the share as ``Batch.counts``) as
their denominators, so each rank's result is its local sum over the
global denominator and the ranks' results sum to the global batch's, as
in JAX, where the loss is one program over the global batch.  Without
counts they divide by their own, the single-process run unchanged.
"""

import numpy as np
import torch

# the entries of a share's counts vector (``global_counts``); every
# utterance's frame count follows from OLENS on
N_UTTS, N_VALID, TOKENS, OLENS = 0, 1, 2, 3


def global_counts(olens, ilens):
    """The global batch's denominators as one float32 vector, made on the
    host where a rank's share is cut (``parallel/distributed.py::
    batch_share``: every rank holds the whole global batch there, so no
    collective makes them): the utterances on the batch axis (padding rows
    included), those with frames (olens > 0), the valid tokens, then every
    utterance's frame count.  A tensor on the device, its values are
    inputs of a CUDA graph, not part of its key: one graph serves every
    batch of one shape."""
    olens = np.asarray(olens)
    head = [len(olens), int((olens > 0).sum()), int(np.asarray(ilens).sum())]
    return np.concatenate([head, olens]).astype(np.float32)


def count_frames(counts, reduction_factor=1):
    """The frame mask's global count (a 0-d tensor), each utterance's
    frames trimmed to a multiple of ``reduction_factor`` as the mel loss
    trims them."""
    olens = counts[OLENS:]
    if reduction_factor > 1:
        olens = olens - torch.remainder(olens, reduction_factor)
    return torch.sum(olens)


def lengths_to_non_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at valid positions."""
    pos = torch.arange(max_len, dtype=lengths.dtype,
                       device=lengths.device)[None, :]
    return pos < lengths[:, None]


def lengths_to_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at padded positions."""
    return ~lengths_to_non_pad_mask(lengths, max_len)


def masked_mean(values, mask, count=None):
    """Mean of ``values`` over elements where ``mask`` is True; ``mask``
    broadcasts against ``values`` and the denominator counts the broadcast
    selection (``masking.py:24-35``: ``masked_select(...).mean()``).
    ``count``: the number of True entries of ``mask`` (before the
    broadcast) over the global batch, a 0-d tensor, for a rank's share of
    it."""
    mask_f = torch.broadcast_to(mask, values.shape).to(values.dtype)
    total = torch.sum(values * mask_f)
    if count is None:
        return total / torch.clamp(torch.sum(mask_f), min=1.0)
    return total / torch.clamp(count * (values.numel() // mask.numel()),
                               min=1.0)


def plain_mean(values, n_utts=None):
    """The unmasked mean over the padded buffer; with ``n_utts`` (the
    global batch's utterances, a 0-d tensor, for a rank's share of it)
    the denominator is the global batch's padded size."""
    if n_utts is None:
        return torch.mean(values)
    return torch.sum(values) / (values.numel() // values.shape[0] * n_utts)


def weighted_masked_sum(err, mask, n_valid_utts):
    """The ``use_weighted_masking`` reduction (``masking.py:38-65``): each
    element weighs ``mask / frames of its utterance``, divided by
    ``n_valid_utts * feat_dim``, then summed.  ``mask`` is (B, T) or
    (B, T, 1), never pre-broadcast over features (the per-utterance count
    is a frame count).  ``n_valid_utts``: a 0-d tensor, this batch's
    count or the global batch's."""
    mask_f = mask.to(err.dtype)
    per_utt_frames = torch.sum(mask_f, dim=1, keepdim=True)
    feat = err.shape[-1] if err.dim() == 3 else 1
    w = mask_f / torch.clamp(per_utt_frames, min=1.0)
    n_valid_utts = torch.clamp(n_valid_utts, min=1.0).to(err.dtype)
    w = w / (n_valid_utts * feat)
    return torch.sum(err * w)


def weighted_l1(pred, target, mask, n_valid_utts):
    """use_weighted_masking L1 (``masking.py:68-70``)."""
    return weighted_masked_sum(torch.abs(pred - target), mask, n_valid_utts)


def weighted_mse(pred, target, mask, n_valid_utts):
    """use_weighted_masking MSE (``masking.py:73-76``)."""
    diff = pred - target
    return weighted_masked_sum(diff * diff, mask, n_valid_utts)


def masked_l1(pred, target, mask, count=None):
    """Masked-mean L1; ``mask=None`` is the unmasked mean over the padded
    buffer (``masking.py:79-84``).  ``count``: for a rank's share of a
    global batch, the global count of ``mask``'s True entries, or with
    ``mask=None`` the global batch's utterances."""
    err = torch.abs(pred - target)
    return plain_mean(err, count) if mask is None \
        else masked_mean(err, mask, count)


def masked_mse(pred, target, mask, count=None):
    """Masked-mean MSE; ``mask=None`` is the unmasked mean
    (``masking.py:87-90``); ``count`` as in ``masked_l1``."""
    diff = pred - target
    err = diff * diff
    return plain_mean(err, count) if mask is None \
        else masked_mean(err, mask, count)
