"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card: raise when CUDA is missing instead of
    running on the CPU.  Pass `"cpu"` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU"
            )
        device = "cuda"
    return torch.device(device)
