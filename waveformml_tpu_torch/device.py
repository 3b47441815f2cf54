"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    the port never falls back to the CPU on its own; pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
