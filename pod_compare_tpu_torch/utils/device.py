"""The device an entry point runs on: CUDA unless the caller names one."""

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else CUDA; raises when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")
