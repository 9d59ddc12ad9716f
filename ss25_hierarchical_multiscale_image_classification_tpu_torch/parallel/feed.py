"""Feeding a data-parallel step: each rank loads and uploads only its rows.

Counterpart of the JAX package's ``parallel/feed.py``. There one process per
host loads its rows and ``make_array_from_process_local_data`` assembles the
global array; here one process per card loads its rows
(:func:`process_batch_slice` of every global batch, which the trainers' batch
iterators take through their ``rows``) and :func:`feed_global_batch` puts
them on the rank's device. The global batch is never assembled: the
collectives of ``parallel/collectives.py`` reduce over the ranks instead.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.profiling import (
    annotate,
    count,
)


def process_batch_slice(global_batch_size: int, rank: int = 0,
                        world_size: int = 1) -> slice:
    """The half-open row range of the global batch that ``rank`` of
    ``world_size`` loads; raises when the batch does not split evenly."""
    per = global_batch_size // world_size
    if global_batch_size % world_size:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{world_size} processes"
        )
    return slice(rank * per, (rank + 1) * per)


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → device, through pinned memory on a card so the copy is
    queued behind the running step instead of waiting for it. On a card,
    the pinning is the span ``hipac.feed.pin``, its bytes counted in
    ``hipac.feed.pinned_bytes``."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        with annotate("hipac.feed.pin"):
            t = t.pin_memory()
        count("hipac.feed.pinned_bytes", a.nbytes)
        return t.to(dev, non_blocking=True)
    return t


def feed_global_batch(tree: Any, device: torch.device) -> Any:
    """This rank's rows (numpy arrays of a tuple, list or dict, or one
    array) as tensors on its ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(x, device) for x in tree)
    return to_device(tree, device)
