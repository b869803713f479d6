"""Segment gathers (port of ``fcl_taco2_tpu/ops/regroup.py:290``; the
plan builders and training gathers come with the training slice)."""


def gather_token_vectors(hs, seg_utt, seg_tok):
    """(B, Tmax, C) token vectors -> (P, C) per-segment encoder vectors."""
    return hs[seg_utt, seg_tok]
