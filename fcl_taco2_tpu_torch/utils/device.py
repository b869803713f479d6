"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda"):
    """Return ``torch.device(device)``; raise when a CUDA device is asked
    for (the default) and none is present.  There is no silent CPU
    fallback: a caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
