"""Length masks and the masked / weighted loss reductions (port of
``fcl_taco2_tpu/ops/masking.py``).

On a rank of a data-parallel run (``parallel/``) a loss sees only its
share of the global batch; the reductions then take the global batch's
counts (``GlobalCounts``, carried by the share as ``Batch.counts``) as
their denominators, so each rank's result is its local sum over the
global denominator and the ranks' results sum to the global batch's, as
in JAX, where the loss is one program over the global batch.  Without
counts they divide by their own, the single-process run unchanged.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GlobalCounts:
    """The global batch's denominators, as host numbers
    (``parallel/distributed.py::make_global_batch``): every rank holds the
    whole global batch on the host, so no collective makes them."""

    n_utts: int     # utterances on the batch axis, padding rows included
    n_valid: int    # utterances with frames (olens > 0)
    tokens: int     # valid token positions: the token mask's count
    olens: tuple    # every utterance's frame count

    def frames(self, reduction_factor=1):
        """The frame mask's count, each utterance's frames trimmed to a
        multiple of ``reduction_factor`` as the mel loss trims them."""
        r = reduction_factor
        return sum(o - o % r for o in self.olens)


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
    broadcast) over the global batch, for a rank's share of it."""
    mask_f = torch.broadcast_to(mask, values.shape).to(values.dtype)
    total = torch.sum(values * mask_f)
    if count is None:
        return total / torch.clamp(torch.sum(mask_f), min=1.0)
    return total / max(count * (values.numel() // mask.numel()), 1)


def plain_mean(values, n_utts=None):
    """The unmasked mean over the padded buffer; with ``n_utts`` (the
    global batch's utterances, for a rank's share of it) the denominator
    is the global batch's padded size."""
    if n_utts is None:
        return torch.mean(values)
    return torch.sum(values) / (values.numel() // values.shape[0] * n_utts)


def weighted_masked_sum(err, mask, n_valid_utts):
    """The ``use_weighted_masking`` reduction (``masking.py:38-65``): each
    element weighs ``mask / frames of its utterance``, divided by
    ``n_valid_utts * feat_dim``, then summed.  ``mask`` is (B, T) or
    (B, T, 1), never pre-broadcast over features (the per-utterance count
    is a frame count).  ``n_valid_utts``: a tensor, or the global batch's
    count as a number."""
    mask_f = mask.to(err.dtype)
    per_utt_frames = torch.sum(mask_f, dim=1, keepdim=True)
    feat = err.shape[-1] if err.dim() == 3 else 1
    w = mask_f / torch.clamp(per_utt_frames, min=1.0)
    if torch.is_tensor(n_valid_utts):
        n_valid_utts = torch.clamp(n_valid_utts, min=1.0).to(err.dtype)
    else:  # the global batch's count, a host number
        n_valid_utts = max(float(n_valid_utts), 1.0)
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
