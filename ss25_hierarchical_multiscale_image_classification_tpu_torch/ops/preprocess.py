"""Fused inference preprocessing: ImageNet normalize + per-patch mean.

Counterpart of the JAX package's ``ops/pallas/preprocess.py::fused_normalize``.
One pass over a uint8 (B, H, W, 3) batch gives the normalized batch and,
from the same read, each patch's mean intensity, which the on-device tissue
filter of ``infer/sliding_window.py`` compares with the white threshold.

For a CUDA tensor :func:`fused_normalize` launches the hand-written kernel
(``ops/csrc/fused_normalize.cu``) or raises; for a CPU tensor it takes
:func:`fused_normalize_reference`, the plain PyTorch version, which the CPU
tests hold against the JAX kernel and which the kernel must equal exactly.
The TPU kernel's rules (B a multiple of 8, a u8→i32→f32 cast hop) do not
carry over: any B ≥ 1 and any H, W are taken.
"""

from __future__ import annotations

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    MEAN_255,
    STD_255,
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(imgs_u8: torch.Tensor, dtype: torch.dtype) -> None:
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4 or imgs_u8.shape[-1] != 3:
        raise ValueError(
            f"expected a (B, H, W, 3) uint8 tensor, got {tuple(imgs_u8.shape)} "
            f"{imgs_u8.dtype}"
        )
    if imgs_u8.shape[0] < 1:
        raise ValueError("empty batch")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"output dtype must be float32 or bfloat16, got {dtype}")


def _means(sums: torch.Tensor, n: int) -> torch.Tensor:
    """Exact integer sums → float32 means: the sum rounded to float32, then
    one IEEE division (a device tensor divisor, see ``normalize``)."""
    return sums.to(torch.float32) / torch.full(
        (), float(n), dtype=torch.float32, device=sums.device
    )


def fused_normalize_reference(imgs_u8: torch.Tensor,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``normalize`` plus the mean over
    each flat patch, summed exactly in int64 as the kernel sums (a float32
    sum rounds once it passes 2^24, which a 224² patch does)."""
    _check(imgs_u8, dtype)
    b = imgs_u8.shape[0]
    sums = imgs_u8.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    return normalize(imgs_u8, dtype), _means(sums, imgs_u8[0].numel())


def fused_normalize(imgs_u8: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 → (normalized (B, H, W, 3) ``dtype``, per-patch
    means (B,) float32).

    A CUDA tensor must be contiguous; the kernel launches on the current
    stream and ``fused_normalize.launches`` counts each launch.
    """
    _check(imgs_u8, dtype)
    dev = imgs_u8.device
    if dev.type == "cpu":
        return fused_normalize_reference(imgs_u8, dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_normalize runs on cuda or cpu, not {dev}")
    if not imgs_u8.is_contiguous():
        raise ValueError("fused_normalize needs a contiguous CUDA tensor")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    lib = load_library()
    b, h, w, c = imgs_u8.shape
    n = h * w * c
    out = torch.empty(imgs_u8.shape, dtype=dtype, device=dev)
    sums = torch.zeros(b, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hipac_fused_normalize(
            imgs_u8.data_ptr(), out.data_ptr(), sums.data_ptr(), b, n,
            int(dtype == torch.bfloat16), *MEAN_255, *STD_255,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_normalize kernel launch failed: cudaError {rc}")
    count_launch(fused_normalize)
    return out, _means(sums, n)


fused_normalize.launches = 0
