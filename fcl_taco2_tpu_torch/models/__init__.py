from fcl_taco2_tpu_torch.models.config import (ModelConfig,  # noqa: F401
                                               student_config, teacher_config)
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA  # noqa: F401
