"""Where the port's entry points run: on the CUDA card unless the caller
names another device. There is no quiet fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device` (a bare ``"cuda"`` gets the current
    card's index); ``None`` means the card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run its plain PyTorch path explicitly")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_model_device(model_device: torch.device, device=None) -> torch.device:
    """The device an entry point driving ``model`` runs on; raises when the
    caller's device (default: the card) is not the model's."""
    device = resolve_device(device)
    if device != model_device:
        raise ValueError(
            f"the model lives on {model_device}, but this entry point runs "
            f"on {device}; pass device={str(model_device)!r}")
    return device
