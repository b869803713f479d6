"""``chip_smoke.py``'s data-parallel phase alone, on one NVIDIA GPU.

    python3 scripts/torch_parallel_phase.py

Runs the smoke script's device and build phases, then ``[parallel]``
(``chip_smoke.py::phase_parallel``: 2 gloo ranks sharing card 0 train,
distil, serve sharded and resume, held to one process, then one NCCL
rank whose graphed train, KD and eval steps and sharded serving are held
to their eager twins bit for bit) in a temporary directory, and prints
the decoder-kernel launches of the two gloo ranks and the NCCL rank and
the wall seconds.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main():
    t0 = time.perf_counter()
    smi = C.phase_device()
    kind = torch.cuda.get_device_name(0)
    C.timed_phase("build", C.phase_build)
    with tempfile.TemporaryDirectory() as root:
        launches = C.timed_phase("parallel", C.phase_parallel, smi, kind,
                                 root)
    print(f"launches (gloo rank 0, rank 1, the NCCL rank) {launches}; {time.perf_counter() - t0:.1f} s "
          f"| {smi}", flush=True)


if __name__ == "__main__":
    main()
