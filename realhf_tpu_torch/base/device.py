"""Device selection.

The port runs on the CUDA card unless the caller asks for the CPU.
``None`` means ``"cuda"``; a CUDA request on a machine without CUDA
raises instead of silently falling back to the CPU (the CPU runs the
plain PyTorch versions of the kernels, which is what tests want and
what a user asking for the card does not).
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {dev}; use 'cuda' or 'cpu'.")
    return dev
