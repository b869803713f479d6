"""The serial-duplicates account of the regroup gathers' backward, on one
NVIDIA GPU: autograd's indexing backward against ``csrc/regroup.cu`` as
the count of padded positions aimed at one row grows.

    python3 scripts/torch_regroup_mechanism.py [--out FILE]

A scatter's shape at the training cells' size: 65,536 positions (batch 64
x Lmax 1,024) read from 95,360 rows (the KD cell's class flats), bf16, at
widths 80 and 256.  Of the positions, ``pad`` aim at row 0 and are not
valid (their gradient zero, as the masks make it in training); the others
aim at distinct rows.  Each case: the two gradients bit-equal, then the
card's ms a call of each (``timing.queued_ms``: calls queued behind a
sleep, so the host's launch stays out).  Autograd's backward sorts the
indices and gives each run of equal ones to one warp, so its time should
grow with ``pad``; the kernel's should not.  Prints one JSON line (and
writes it to ``--out``).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from fcl_taco2_tpu_torch.ops import regroup_cuda as R  # noqa: E402
from fcl_taco2_tpu_torch.utils import timing  # noqa: E402

N, ROWS = 64 * 1024, 95_360
PADS = (0, 1_000, 8_000, 29_000)
WIDTHS = (80, 256)


def case(pad, C, dev, seed=0):
    """(g, indices, valid, lead) of one scatter with ``pad`` padded
    positions spread over the batch."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[torch.randperm(N, generator=gen, device=dev)[:pad]] = False
    rows = torch.randperm(ROWS - 1, generator=gen, device=dev)[:N] + 1
    idx = torch.where(valid, rows, 0).to(torch.int32)
    g = torch.randn(N, C, generator=gen, device=dev).to(torch.bfloat16)
    return g * valid[:, None].to(g.dtype), (idx,), valid, (ROWS,)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = timing.card()
    dev = torch.device("cuda")
    rows = []
    for C in WIDTHS:
        for pad in PADS:
            g, idx, valid, lead = case(pad, C, dev)
            if not torch.equal(R.gather_backward(g, idx, valid, lead),
                               R.gather_backward_plain(g, idx, valid,
                                                       lead)):
                raise RuntimeError(f"pad {pad} width {C}: the gradients "
                                   "differ")
            kernel = timing.queued_ms(
                lambda: R.gather_backward(g, idx, valid, lead), 20)
            plain = timing.queued_ms(
                lambda: R.gather_backward_plain(g, idx, valid, lead), 5)
            rows.append({"width": C, "padded": pad, "kernel_ms": kernel,
                         "autograd_ms": plain})
            print(f"width {C} padded {pad}: autograd {plain:.4f} ms, "
                  f"kernel {kernel:.4f} ms", flush=True)
    line = json.dumps({"regroup_mechanism": rows, "positions": N,
                       "rows": ROWS, "dtype": "bfloat16",
                       "card": card["smi"]})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
