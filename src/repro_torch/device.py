"""Device placement for the port's entry points.

Entry points (``DeviceEngine.from_store``, ``ServingEngine``,
``models.model.init_params``, ``launch/serve.py``) take a ``device``
argument.  ``None`` means the card: the port never falls back to the CPU
on its own, so a missing card is an error and the CPU is an explicit
choice (``device="cpu"``, as the tests use).
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is visible); otherwise
    the named device, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless a device is given, and no "
                "CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
