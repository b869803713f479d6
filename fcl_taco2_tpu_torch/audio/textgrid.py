"""Praat TextGrid parser (long and short text formats); a copy of
``fcl_taco2_tpu/audio/textgrid.py``.

Replaces the reference's `tgt` dependency (its preprocess.py:27,
165-196 read MFA alignments from TextGrid 'phones' tiers).  MFA emits
long-format IntervalTiers; both long and short formats are handled, UTF-8 /
UTF-16 transparently.
"""

import re
from typing import List, NamedTuple


class Interval(NamedTuple):
    xmin: float
    xmax: float
    text: str


class Tier(NamedTuple):
    name: str
    intervals: List[Interval]


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUM = re.compile(r'-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?')


def _read_text(path):
    with open(path, "rb") as f:
        raw = f.read()
    for enc in ("utf-8", "utf-16", "latin-1"):
        try:
            return raw.decode(enc)
        except UnicodeDecodeError:
            continue
    raise ValueError(f"cannot decode {path}")


def read_textgrid(path) -> List[Tier]:
    """Parse a TextGrid file into tiers of intervals.

    Tolerant tokenizer: walks the file as a stream of quoted strings and
    numbers, using the 'IntervalTier' markers as section boundaries — this
    handles both long format (with 'item [k]:' headers) and short format.
    """
    text = _read_text(path)
    # token stream: quoted strings and bare numbers in order
    tokens = []
    for m in re.finditer(r'"(?:[^"]|"")*"|' + _NUM.pattern, text):
        tok = m.group(0)
        if tok.startswith('"'):
            tokens.append(("s", tok[1:-1].replace('""', '"')))
        else:
            tokens.append(("n", float(tok)))

    tiers = []
    i = 0
    n = len(tokens)
    while i < n:
        kind, val = tokens[i]
        if kind == "s" and val == "IntervalTier":
            # layout: "IntervalTier" "<name>" xmin xmax n_intervals then per
            # interval a run of numbers ending in the quoted label.  Long
            # format interleaves index numbers from "intervals [k]:" /
            # "item [k]:" headers, so per interval we take the LAST TWO
            # numbers before the label as (xmin, xmax) — correct for both
            # long and short formats.
            name = tokens[i + 1][1]
            count = int(tokens[i + 4][1])
            j = i + 5
            intervals = []
            for _ in range(count):
                nums = []
                while j < n and tokens[j][0] == "n":
                    nums.append(tokens[j][1])
                    j += 1
                if j >= n or len(nums) < 2:
                    raise ValueError(f"malformed interval in tier {name!r}")
                label = tokens[j][1]
                j += 1
                intervals.append(Interval(float(nums[-2]), float(nums[-1]),
                                          label))
            tiers.append(Tier(name, intervals))
            i = j
        else:
            i += 1
    if not tiers:
        raise ValueError(f"no IntervalTier found in {path}")
    return tiers


def get_tier(tiers: List[Tier], name: str) -> Tier:
    for t in tiers:
        if t.name == name:
            return t
    raise KeyError(f"tier {name!r} not in {[t.name for t in tiers]}")
