"""Train state: the model (parameters and BatchNorm running statistics),
the optimizer state and the step count (port of
``fcl_taco2_tpu/train/state.py``)."""

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    model: Any         # models.taco2_sa.Tacotron2SA: the JAX state's params
    #                    (parameters) and model_state (BatchNorm buffers)
    opt_state: dict    # train.optim.Optimizer.init(...)
    step: int = 0
    tx: Any = None     # the train.optim.Optimizer of opt_state: with it,
    #                    checkpoints hold opt_state in optax's layout
