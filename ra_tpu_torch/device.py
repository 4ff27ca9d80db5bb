"""Device selection for the port's entry points.

Every entry point (``LockstepEngine(..., device=None)`` and friends) runs
on the CUDA card unless the caller asks for the CPU by name.  Nothing
falls back quietly: asking for the card where there is none raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` resolves to ``cuda``; ``"cpu"`` (or ``torch.device("cpu")``)
    is the only way onto the CPU.  A CUDA device where
    ``torch.cuda.is_available()`` is False raises ``RuntimeError``, and so
    does any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}: the port runs on "
                           "'cuda', or on 'cpu' when asked by name")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev
