"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of None means ``cuda``, and a missing CUDA runtime raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises if CUDA is absent); anything else is taken
    as the caller's explicit choice (``"cpu"`` for the plain versions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "selkies_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
