"""Where the port runs: one place resolves the device of an entry point.

``device=None`` means the card.  Without CUDA that is an error — an entry
point never carries on on the CPU unless the caller asked for it with
``device="cpu"`` (the tests do, to run the kernels' plain versions).
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the card; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
