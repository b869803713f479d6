from fcl_taco2_tpu_torch.data.manifest import (Utterance,  # noqa: F401
                                               load_manifest)
