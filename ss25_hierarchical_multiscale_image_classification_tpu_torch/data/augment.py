"""Inference-time preprocessing: ImageNet normalize and bilinear resize.

Counterparts of the JAX package's ``data/augment.py::normalize`` and of the
``jax.image.resize(..., "bilinear")`` call in its sliding-window step. The
training augmentations wait for the training slice.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)


#: Per-channel ``255·mean_c`` and ``255·std_c``, products in float64; both
#: the plain normalize and the CUDA kernel round them once to float32.
MEAN_255: tuple[float, ...] = tuple(m * 255.0 for m in IMAGENET_MEAN)
STD_255: tuple[float, ...] = tuple(s * 255.0 for s in IMAGENET_STD)


@functools.lru_cache(maxsize=None)
def _affine(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(:data:`MEAN_255`, :data:`STD_255`) as (3,) float32 tensors on
    ``device``, made once: made per call on a card, each would be a copy
    from pageable host memory, which waits for the stream to drain."""
    return (torch.tensor(MEAN_255, dtype=torch.float32, device=device),
            torch.tensor(STD_255, dtype=torch.float32, device=device))


def normalize(imgs_u8: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """uint8 (B, H, W, 3) → ImageNet-normalized (B, H, W, 3) ``dtype``.

    Computes ``(x − 255·mean_c) / (255·std_c)`` in float32 and rounds once
    to ``dtype``. The divisor is a (3,) device tensor, not a Python scalar:
    PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
    which is not the IEEE quotient the kernel computes.
    """
    mean, std = _affine(imgs_u8.device)
    out = (imgs_u8.to(torch.float32) - mean) / std
    return out.to(dtype)


def resize(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """Float (B, H, W, C) → (B, size, size, C), bilinear with half-pixel
    centres and, when shrinking, an antialiasing filter: what
    ``jax.image.resize(..., "bilinear")`` computes (without ``antialias``
    a 448→224 shrink is off by up to 83 grey levels)."""
    x = F.interpolate(imgs.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)
