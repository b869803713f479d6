from fcl_taco2_tpu_torch.infer.pipeline import (  # noqa: F401
    TTSPipeline, pwg_receptive_field, vocode_chunked)
from fcl_taco2_tpu_torch.infer.stream import StreamTTS  # noqa: F401
from fcl_taco2_tpu_torch.infer.synth import Synthesizer  # noqa: F401
