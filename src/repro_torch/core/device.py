"""The device a ``repro_torch`` entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  The default everywhere is the
    card; without one this raises instead of carrying on on the CPU
    (pass ``device="cpu"`` to run the plain PyTorch versions there)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the monitor's plain PyTorch version on the host")
        if dev.index is None:           # "cuda" -> the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
