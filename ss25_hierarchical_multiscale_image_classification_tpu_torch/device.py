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


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: ``"cuda"`` without an index is
    ``cuda:LOCAL_RANK`` (``torchrun`` sets it for each rank; 0 when unset),
    anything else :func:`resolve_device`'s. Raises when the card is missing, as
    :func:`resolve_device` does, rather than sharing another card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or torch.device(device).index is not None:
        return dev
    import os

    local = int(os.environ.get("LOCAL_RANK", 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA "
            "device(s) are visible"
        )
    return torch.device("cuda", local)


def cuda_devices() -> list[torch.device]:
    """Every visible card, in index order; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
