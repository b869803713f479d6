"""Knowledge-distillation training throughput on the ``fcl_train
--perform-KD True`` step path: ``KDTrainer``'s one step a dispatch
(``make_kd_train_step``: the frozen teacher's forward and the student's
step in one graph), each batch assembled from ``DeviceBatchCache`` on the
consumer's side of the trainer's ``PrefetchLoader``.  The student is the
cell's configuration, with the KD command line's ``model_overrides``
(``remat_decoder``); the teacher is the configuration the mix names,
both seeded.  Everything else, the corpus, the batches, the window and
the check, is the training driver's (``drivers/train.py``)."""

import json
import os

from benchmark import weights
from benchmark.drivers import train
from benchmark.reference import train as ref_train

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Driver(train.Driver):
    def __init__(self, config, mix, seed, device, options=None):
        super().__init__(config, mix, seed, device, options)
        with open(os.path.join(HERE, "configs", mix["teacher"] + ".json")) \
                as f:
            self.teacher_config = json.load(f)
        # the readers count the teacher's forward in the step's work
        config["teacher_model"] = self.teacher_model_config()

    def model_config(self):
        return dict(super().model_config(), **self.mix["model_overrides"])

    def teacher_model_config(self):
        return dict(self.teacher_config["model"],
                    duration_classes=list(self.mix["duration_classes"]))

    def make_model(self, mc):
        from fcl_taco2_tpu_torch.models import ModelConfig
        from fcl_taco2_tpu_torch.models.kd import KDStudent
        self.kd = KDStudent(mc, ModelConfig(**self.teacher_model_config()),
                            share_proj=self.mix["share_proj"],
                            device=self.device)
        self.sd = weights.seeded_state(self.kd.student, self.seed,
                                       self.device, tag="model")
        self.kd.student.load_state_dict(self.sd)
        self.tsd = weights.seeded_state(self.kd.teacher, self.seed,
                                        self.device, tag="teacher")
        self.kd.teacher.load_state_dict(self.tsd)
        self.teacher_names = [n for n, _ in
                              self.kd.teacher.named_parameters()]
        return self.kd.student

    def make_step(self):
        from fcl_taco2_tpu_torch.train.step import make_kd_train_step
        self.train_step = make_kd_train_step(self.kd, self.tx)

    def prepare(self, pack):
        """The KD step is captured at its first call, as the trainer's
        first step captures it."""

    def step(self, packs):
        import torch
        from fcl_taco2_tpu_torch.train.step import (pack_report,
                                                    step_generator)
        reps = []
        for p in packs:
            self.ts, report = self.train_step(
                self.ts, self.dc.assemble(p),
                step_generator(self.train_seed, self.ts.step, self.device))
            self.keys, packed = pack_report(report)
            reps.append(packed)
        return torch.stack(reps)

    def report_keys(self):
        return self.keys

    def graphs(self):
        return self.train_step.graphs

    def free(self):
        super().free()
        del self.kd

    def ref_loss(self, leaves, mc, batch, gen, pr, rows=None):
        teacher = {k: self.tsd[k].float() for k in self.teacher_names}
        return ref_train.kd_loss_fn(leaves, teacher, mc,
                                    self.teacher_model_config(), batch, gen,
                                    pr, rows)[0]
