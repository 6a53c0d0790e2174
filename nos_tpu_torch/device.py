"""The port's device rule, in one place.

Every entry point takes an explicit ``device=``. Left as None it means
the card: ``cuda`` when PyTorch sees one, and an error when it does not —
the port never drops to the CPU on its own. Tests pass ``device="cpu"``
and then every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None resolves to ``cuda`` and
    raises when no CUDA device is visible."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible and no device= was given: the "
            "port runs on the card by default; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda")
