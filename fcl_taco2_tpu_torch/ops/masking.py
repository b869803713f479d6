"""Length masks and the masked / weighted loss reductions (port of
``fcl_taco2_tpu/ops/masking.py``)."""

import torch


def lengths_to_non_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at valid positions."""
    pos = torch.arange(max_len, dtype=lengths.dtype,
                       device=lengths.device)[None, :]
    return pos < lengths[:, None]


def lengths_to_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at padded positions."""
    return ~lengths_to_non_pad_mask(lengths, max_len)


def masked_mean(values, mask):
    """Mean of ``values`` over elements where ``mask`` is True; ``mask``
    broadcasts against ``values`` and the denominator counts the broadcast
    selection (``masking.py:24-35``: ``masked_select(...).mean()``)."""
    mask_f = torch.broadcast_to(mask, values.shape).to(values.dtype)
    total = torch.sum(values * mask_f)
    return total / torch.clamp(torch.sum(mask_f), min=1.0)


def weighted_masked_sum(err, mask, n_valid_utts):
    """The ``use_weighted_masking`` reduction (``masking.py:38-65``): each
    element weighs ``mask / frames of its utterance``, divided by
    ``n_valid_utts * feat_dim``, then summed.  ``mask`` is (B, T) or
    (B, T, 1), never pre-broadcast over features (the per-utterance count
    is a frame count)."""
    mask_f = mask.to(err.dtype)
    per_utt_frames = torch.sum(mask_f, dim=1, keepdim=True)
    feat = err.shape[-1] if err.dim() == 3 else 1
    w = mask_f / torch.clamp(per_utt_frames, min=1.0)
    w = w / (torch.clamp(n_valid_utts, min=1.0).to(err.dtype) * feat)
    return torch.sum(err * w)


def weighted_l1(pred, target, mask, n_valid_utts):
    """use_weighted_masking L1 (``masking.py:68-70``)."""
    return weighted_masked_sum(torch.abs(pred - target), mask, n_valid_utts)


def weighted_mse(pred, target, mask, n_valid_utts):
    """use_weighted_masking MSE (``masking.py:73-76``)."""
    diff = pred - target
    return weighted_masked_sum(diff * diff, mask, n_valid_utts)


def masked_l1(pred, target, mask):
    """Masked-mean L1; ``mask=None`` is the unmasked mean over the padded
    buffer (``masking.py:79-84``)."""
    err = torch.abs(pred - target)
    return torch.mean(err) if mask is None else masked_mean(err, mask)


def masked_mse(pred, target, mask):
    """Masked-mean MSE; ``mask=None`` is the unmasked mean
    (``masking.py:87-90``)."""
    diff = pred - target
    err = diff * diff
    return torch.mean(err) if mask is None else masked_mean(err, mask)
