"""The decoder's prenet dropout at inference, drawn as the served model
draws it: a counter-based Philox4x32-10 keyed on (seed, row, step,
layer * units + unit), the first output word compared with
floor((1 - rate) * 2**32).  ``row`` is the segment's place in the
duration-sorted order of the batch's B * Tmax token slots (stable, longest
first), ``step`` the frame within the segment, ``layer`` 0 or 1 of the
prenet.  A frozen copy of the keying, in 64-bit integer tensor
arithmetic, so it runs on the CPU and on the card alike.
"""

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_K1 = 0x5BD1E995
_MASK = 0xFFFFFFFF


def philox_bits(seed, c0, c1, c2):
    """First word of Philox4x32-10 with key (seed, 0x5BD1E995) and counter
    (c0, c1, c2, 0); ``c*`` int64 tensors of values in [0, 2**32) that
    broadcast together, ``seed`` an int.  Returns int64 in [0, 2**32)."""
    x0, x1, x2 = (torch.as_tensor(c).long() for c in (c0, c1, c2))
    x0, x1, x2 = torch.broadcast_tensors(x0, x1, x2)
    x3 = torch.zeros_like(x0)
    k0, k1 = int(seed) & _MASK, _K1
    for _ in range(10):
        p0 = x0 * _M0  # < 2**64: wraps in int64, low 64 bits kept
        p1 = x2 * _M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return x0


def keep_threshold(rate):
    """floor((1 - rate) * 2**32), computed in double as the kernel does."""
    return int((1.0 - float(rate)) * 4294967296.0)


def prenet_keep(seed, rate, rows, step, layer, units, device=None):
    """(len(rows), units) bool: the prenet units kept at ``step`` and
    ``layer`` for the sorted rows ``rows`` (an int tensor)."""
    rows = torch.as_tensor(rows, device=device).long()[:, None]
    cols = (layer * units
            + torch.arange(units, device=rows.device).long())[None, :]
    bits = philox_bits(seed, rows, torch.tensor(step, device=rows.device),
                       cols)
    return bits < keep_threshold(rate)
