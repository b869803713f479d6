"""``chip_smoke.py``'s quality phase alone, on one NVIDIA GPU.

    python3 scripts/torch_quality_phase.py [--epochs N ...]

Runs the smoke script's device and build phases, the teacher batch-16
``hybrid`` vs ``auto`` decode of ``[main]`` (``main_hybrid``), then
``[preprocess]`` (which writes the features) and ``[quality]``
(``chip_smoke.py::phase_quality``: FCL-taco2-T trained with
``fcl_train``'s defaults, its test-shard decodes in bf16 and int8, a KD
student and its decodes, the L1-floor and validation-loss gates) in a
temporary directory.  ``--epochs`` runs the quality phase once per
teacher epoch count given (each from scratch, each gated), to find how
many the gate needs; a failed check is printed and the next one runs,
and the exit code is 1 if any failed.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def log_curve(path):
    """The teacher's per-epoch losses in one line: epoch, train loss,
    validation loss and its L1, duration, pitch and energy terms."""
    if not os.path.exists(path):
        return
    keys = ("main/loss", "validation/main/loss", "validation/main/l1_loss",
            "validation/main/dur_loss", "validation/main/pitch_loss",
            "validation/main/energy_loss")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    print("[quality] curve (epoch, " + ", ".join(keys) + "): " + json.dumps(
        [[r["epoch"]] + [round(r[k], 4) for k in keys] for r in rows]),
        flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, nargs="*",
                   default=[C.QUALITY_EPOCHS])
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    smi = C.phase_device()
    kind = torch.cuda.get_device_name(0)
    C.timed_phase("build", C.phase_build)
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    models = {"teacher": Tacotron2SA(teacher_config(C.IDIM, odim=C.ODIM),
                                     seed=0)}
    _, _, toks16, durs16 = C.protocol()
    failed = []

    def attempt(name, fn, *a):
        try:
            return C.timed_phase(name, fn, *a)
        except RuntimeError as e:  # a failed check: report, go on
            print(f"[{name}] FAILED: {e}", flush=True)
            failed.append(name)

    attempt("hybrid", C.main_hybrid, models, kind, toks16, durs16)
    del models
    with tempfile.TemporaryDirectory() as root:
        C.timed_phase("preprocess", C.phase_preprocess, smi, kind, root)
        for epochs in args.epochs:
            C.QUALITY_EPOCHS = epochs
            launches = attempt(f"quality ep{epochs}", C.phase_quality, smi,
                               kind, os.path.join(root, f"ep{epochs}"),
                               os.path.join(root, "features"))
            print(f"[quality] {epochs} epochs: launches {launches}",
                  flush=True)
            log_curve(os.path.join(root, f"ep{epochs}", "q_teacher",
                                   "log.jsonl"))
    print(f"{time.perf_counter() - t0:.1f} s, failed {failed} | {smi}",
          flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
