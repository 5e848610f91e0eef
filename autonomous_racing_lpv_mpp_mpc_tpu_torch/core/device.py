"""The port's default device.

Every constructor that makes tensors from scratch (tracks, scenario
grids, references, parameter rows, converted JAX objects) takes
``device=None`` and resolves it here: ``None`` means the CUDA card, so the
kernel wrappers downstream launch their kernels. A CPU run asks for it with
``device="cpu"``; the wrappers then take their plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given. Raises
    ``RuntimeError`` for a CUDA device when no card is present: nothing
    falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's tensors default to the card; "
            "pass device='cpu' to run on the CPU")
    return dev
