"""The port's workflow scripts (``scripts/torch_{teacher,student}_model_
training.sh``, ``scripts/torch_inference.sh``), the counterparts of the
JAX package's three: the teacher script trains FCL-taco2-T's recipe at
tiny widths on the CPU, its flags (seed 137, the teacher config, no KD)
reaching ``fcl_train`` and the extra flags overriding them."""

import json
import os
import subprocess
import sys
from pathlib import Path

from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
from fcl_taco2_tpu_torch.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parent.parent
TINY = ["--embed-dim", "16", "--eunits", "16", "--econv-chans", "16",
        "--dunits", "20", "--prenet-units", "12", "--postnet-layers", "3",
        "--postnet-chans", "10", "--duration-predictor-chans", "14",
        "--max-dur", "6", "--duration-classes", "3", "--compute-dtype",
        "float32", "--batch-size", "4", "--epochs", "1"]


def test_teacher_script_trains_at_tiny_widths(tmp_path):
    root = str(tmp_path)
    train, valid = write_learnable_corpus(root, 8, 4)
    env = dict(os.environ, EXP=os.path.join(root, "exp"), DEVICE="cpu",
               OMP_NUM_THREADS="1",
               PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    run = subprocess.run(
        ["bash", str(REPO / "scripts" / "torch_teacher_model_training.sh"),
         "--train-json", train, "--valid-json", valid, *TINY],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    out = os.path.join(root, "exp", "results")
    assert os.path.exists(os.path.join(out, "model.loss.best"))
    cfg, _ = ckpt.load_model_json(out)
    # the teacher yaml's knobs, the tiny widths given after them
    assert cfg.dunits == 20 and cfg.prenet_layers == 2
    assert cfg.use_fe_condition and cfg.dropout_rate == 0.5
    with open(os.path.join(out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and rows[0]["epoch"] == 1
