"""Summation order against the data-parallel check's limit, on one NVIDIA
GPU.

    python3 scripts/torch_parallel_witness.py

``[parallel]`` (``chip_smoke.py::phase_parallel``) holds 2 ranks' losses
to one process's at rtol 2e-4 and trains at Adam lr 1e-4
(``parallel/_mp_worker.py::LR``).  This script measures why not 1e-3:
FCL-taco2-T (fp32, TF32 off, dropouts 0) trains 3 steps on the
benchmark's B=16 batch in one process, with the utterances as made and
in two other orders (the halves swapped, as 2 ranks hold them; reversed),
which is the same math summed in other orders, at lr 1e-3 and at 1e-4.
Then 2 gloo ranks sharing card 0 at lr 1e-3 against one process.  Each
line prints the losses and, a step each, |difference| / (1e-5 + 2e-4
|loss|): above 1 fails ``[parallel]``'s limit.  About 2 minutes of the
card.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import tf32  # noqa: E402


def err_over_limit(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want) / (1e-5 + C.TOL_PAR * np.abs(want))).tolist()


def main():
    from fcl_taco2_tpu_torch.parallel import _mp_worker as W
    t0 = time.perf_counter()
    smi = C.phase_device()
    B = 16
    orders = {"as made": None,
              "halves swapped": np.r_[B // 2:B, 0:B // 2],
              "reversed": np.arange(B)[::-1]}
    ref = {}
    with tf32(False):
        for lr in (1e-3, 1e-4):
            for name, order in orders.items():
                losses, _, _, norms = W.run_training_steps(
                    3, device="cuda", width="full", lr=lr, order=order)
                base = ref.setdefault(lr, losses)
                C.log(f"[witness] one process, lr {lr:g}, utterances "
                      f"{name}: losses {losses}, grad norms {norms}; "
                      f"error / limit a step {err_over_limit(losses, base)}")
    with tempfile.TemporaryDirectory() as root:
        got, _ = C.spawn_ranks(2, os.path.join(root, "w.json"), "--mode",
                               "dp", "--steps", "3", "--lr", "1e-3")
    C.log(f"[witness] 2 gloo ranks sharing card 0, lr 1e-3: losses "
          f"{got['dp']['losses']}; error / limit a step against one "
          f"process {err_over_limit(got['dp']['losses'], ref[1e-3])}")
    C.log(f"[witness] {time.perf_counter() - t0:.1f} s | {smi} | "
          f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
