"""The output check's control at a size a test run holds (CPU, tiny
widths, every part in fp32 so the program's CPU path and the reference
agree to rounding): the reference computed one precision below the
stated one, put in the program's place, reads far above the program on
every cell kind; on the card at the cells' own sizes ``control.py``
reads both (``PERF.md`` holds the readings the limits come from)."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "student-tts-b1": ("fcl-taco2-S", {}, "wav_rms_err"),
    "teacher-train-b64": ("fcl-taco2-T", {
        "corpus_size": 32, "batch": 8, "epochs": 3, "chain": 2,
        "max_steps_per_s": 200}, "loss_gap"),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_the_control_reads_far_above_the_program(cell):
    cfg, mix, key = CASES[cell]
    r = control.readings(harness.load_spec(tiny.ROOT), cell, [3, 4], 0.2,
                         2, device="cpu",
                         config_override=tiny.config(cfg, "float32"),
                         mix_override=tiny.mix(**mix), emit=lambda _: None)
    lower = max(n[key] for n in r["program"])
    upper = min(n[key] for n in r["control"])
    assert upper > 3 * lower, (lower, upper)
    if "half_batch" in r:
        assert min(n["loss_gap"] for n in r["half_batch"]) > 3 * lower


def test_the_synth_control_reads_the_program_int8_path():
    _, _, _, _, limits = harness.resolve(harness.load_spec(tiny.ROOT),
                                         "teacher-synth-b16")
    assert limits["control"]["program_options"] == {"quantize": "int8"}
