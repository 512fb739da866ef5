"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, and raises
    where there is none: the CPU runs only when the caller asks for it
    (`device="cpu"`, the plain torch path on the host)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {who} runs on the card; pass "
            "device='cpu' for the plain torch path on the host")
    return torch.device("cuda")
