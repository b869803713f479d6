from fcl_taco2_tpu_torch.infer.synth import Synthesizer  # noqa: F401
