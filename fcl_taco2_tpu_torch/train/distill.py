"""KD training: the ``Trainer`` with the distillation loss (port of
``fcl_taco2_tpu/train/distill.py``).

Replaces the reference's tts_distill.py:312-623: the frozen teacher is
built from its config and a checkpoint (mandatory, tts_distill.py:370-375)
and loaded once; the standard loop then trains the student and its
projections.  Snapshots hold the student's tree plus ``kd_proj`` in the
JAX package's layout, so both packages load them.  Data parallel as
``Trainer``: every rank loads the teacher and runs it on its share of the
batch (in train mode, as JAX does, so its BatchNorm statistics are the
global batch's too).
"""

import dataclasses

from fcl_taco2_tpu_torch.train.checkpoint import (load_params_only,
                                                  save_model_json)
from fcl_taco2_tpu_torch.train.loop import Trainer
from fcl_taco2_tpu_torch.train.step import (make_kd_eval_step,
                                            make_kd_train_step)


class KDTrainer(Trainer):
    """``kd``: a ``models.kd.KDStudent``; ``teacher_checkpoint``: a
    checkpoint of the teacher written by either package.  ``device``
    defaults to the card and raises when none is present.  The device
    cache serves KD as it serves the teacher's training; the steps stay
    one a dispatch, as in the JAX package, each a replay of the KD step's
    CUDA graph on the card (``train/step.py::TrainStep``: the teacher's
    forward and the student's step in one graph).  ``mesh`` as in
    ``Trainer``."""

    def __init__(self, kd, tcfg, train_utts, val_utts,
                 teacher_checkpoint: str, device="cuda", mesh=None):
        if not teacher_checkpoint:
            raise ValueError("KD needs the teacher's checkpoint "
                             "(tts_distill.py:370-375)")
        self.kd = kd
        super().__init__(kd.student, tcfg, train_utts, val_utts,
                         device=device, mesh=mesh)
        kd.teacher.to(self.device)
        load_params_only(teacher_checkpoint, kd.teacher)
        if not self.rank0:
            return
        save_model_json(tcfg.exp_dir, kd.scfg, extra={
            "train_config": dataclasses.asdict(tcfg),
            "teacher_config": dataclasses.asdict(kd.tcfg),
            "teacher_checkpoint": teacher_checkpoint,
        })

    def _build_steps(self):
        self.train_step = make_kd_train_step(self.kd, self.tx, self.mesh)
        self.eval_step = make_kd_eval_step(self.kd, self.mesh)
        # the KD step closes over the frozen teacher, so the chained
        # dispatch is not wired for it (distill.py:935-946)
        self.chain_step = None
        self._spd = 1
        if self.tcfg.steps_per_dispatch > 1:
            print("steps_per_dispatch: not supported for KD training; "
                  "running one step per dispatch", flush=True)
