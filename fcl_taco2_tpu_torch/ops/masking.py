"""Length masks (port of ``fcl_taco2_tpu/ops/masking.py:13-22``)."""

import torch


def lengths_to_non_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at valid positions."""
    pos = torch.arange(max_len, dtype=lengths.dtype,
                       device=lengths.device)[None, :]
    return pos < lengths[:, None]


def lengths_to_pad_mask(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True at padded positions."""
    return ~lengths_to_non_pad_mask(lengths, max_len)
