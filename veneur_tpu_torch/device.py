"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else an
    error. The CPU is taken only when the caller names it, so a missing
    GPU never turns into a quiet CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
