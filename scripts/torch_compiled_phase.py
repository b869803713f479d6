"""``chip_smoke.py``'s compiled-execution phase alone, on one NVIDIA GPU.

    python3 scripts/torch_compiled_phase.py [--no-kernels]

Runs the smoke script's device and build phases, the four kernels
against their plain versions with the main path's device scalars
(``[kernels]``, ``[dropout]``, ``[pwg]``; ``--no-kernels`` builds the PWG
weights without them), then ``[compiled]``
(``chip_smoke.py::phase_compiled``): serving, text -> wav and the stream
as CUDA graph replays against their eager calls bit for bit, then the
``scan`` and ``hybrid`` routes, ``fcl_vocode``'s bucket, a
``vocode_chunked`` utterance and one preprocessing bucket likewise, and the
graphed train, KD and eval steps against eager ones under deterministic
algorithms, with the times beside each.  Exits non-zero if a check fails.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--no-kernels", action="store_true")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    smi = C.phase_device()
    kind = torch.cuda.get_device_name(0)
    C.timed_phase("build", C.phase_build)
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    models = {
        "teacher": Tacotron2SA(teacher_config(C.IDIM, odim=C.ODIM), seed=0),
        "student": Tacotron2SA(student_config(C.IDIM, odim=C.ODIM), seed=0),
    }
    if args.no_kernels:
        from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
        pwg = ParallelWaveGAN(PWGConfig(), seed=0)
    else:
        C.timed_phase("kernels", C.phase_kernels, models)
        C.timed_phase("dropout", C.phase_dropout, models)
        pwg, _ = C.timed_phase("pwg", C.phase_pwg_kernels)
    launches = C.timed_phase("compiled", C.phase_compiled, models, pwg, smi,
                             kind)
    C.log(f"[compiled] launches of the graphed serving calls {launches}; "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
