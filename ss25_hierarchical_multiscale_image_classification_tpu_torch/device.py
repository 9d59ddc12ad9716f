"""Explicit device selection: the port never moves anything implicitly."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) → ``torch.device``.

    Raises when CUDA is asked for and no card is visible, rather than
    falling back to the CPU: a run that asked for the card and silently got
    the CPU would report CPU numbers under a device's name.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and dev.index is None:
        # pin the index so it compares equal to a tensor's .device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
