"""The classifier's training augmentation as two hand-written CUDA kernels.

The JAX package's ``data/augment.py::augment_batch`` (D4 element, colour
affine, clip, ImageNet normalize) has no Pallas kernel: XLA fuses it into a
few passes inside the jitted train step. Eager PyTorch would run each of its
~15 operations as a pass over the batch, so the port's trainer runs it as
``ops/csrc/augment.cu``: one pass for each image's exact byte sum, then the
affine from the draws and the mean (plain PyTorch on (B,) vectors), then one
pass that reads every pixel through its D4 map (looked up in the kernel
from the draws) and writes the normalized float32 output.

For a CUDA tensor :func:`augment_batch_kernel` launches the two kernels or
raises; ``augment_batch_kernel.launches`` counts each launch (two a call).
For a CPU tensor it takes ``data/augment.py::augment_batch``, the plain
version, which the CPU tests hold against the JAX function and which the
kernels must equal bit for bit.
"""

from __future__ import annotations

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    _D4_FX,
    _D4_FY,
    _D4_T,
    MEAN_255,
    STD_255,
    augment_batch,
    augment_color,
    augment_means,
)

#: bfloat16(1/255) as a float: the kernel's channel scale
INV_255_BF16 = torch.tensor(1.0 / 255.0, dtype=torch.bfloat16).item()

#: The D4 tables packed for the kernel: for the draws (h, v, k), 3 bits at
#: 3·(8h + 4v + k): transpose, x-reverse (·2), y-reverse (·4).
D4_PACKED = sum(
    int(_D4_T[h, v, k] + 2 * _D4_FX[h, v, k] + 4 * _D4_FY[h, v, k])
    << (3 * (8 * h + 4 * v + k))
    for h in range(2) for v in range(2) for k in range(4))


def _check(params: dict, imgs_u8: torch.Tensor) -> None:
    if (imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4
            or imgs_u8.shape[-1] != 3):
        raise ValueError(f"expected a (B, S, S, 3) uint8 tensor, got "
                         f"{tuple(imgs_u8.shape)} {imgs_u8.dtype}")
    b, h, w = imgs_u8.shape[:3]
    if h != w:
        raise ValueError(f"D4 augmentation needs square images, got {h}×{w}")
    if b < 1:
        raise ValueError("empty batch")
    for key in ("h", "v", "k", "fb", "fc", "fs", "fh"):
        if params[key].shape != (b,) or params[key].device != imgs_u8.device:
            raise ValueError(f"params[{key!r}] must be ({b},) on "
                             f"{imgs_u8.device}")


def augment_batch_kernel(params: dict, imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) → normalized float32 (B, S, S, 3): the training
    augmentation of ``params`` (see ``data/augment.py::augment_batch``),
    in bfloat16 colour arithmetic.

    A CUDA tensor must be contiguous, B ≤ 65535; the kernels launch on the
    current stream.
    """
    _check(params, imgs_u8)
    dev = imgs_u8.device
    if dev.type == "cpu":
        return augment_batch(params, imgs_u8)
    if dev.type != "cuda":
        raise ValueError(f"augment_batch_kernel runs on cuda or cpu, not {dev}")
    if not imgs_u8.is_contiguous():
        raise ValueError("augment_batch_kernel needs a contiguous CUDA tensor")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        on_device,
    )

    lib = load_library()
    b, s = imgs_u8.shape[0], imgs_u8.shape[1]
    n = s * s * 3
    if b > 65535:
        raise ValueError(f"augment_batch_kernel takes at most 65535 images, "
                         f"got {b}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums = torch.zeros(b, dtype=torch.int64, device=dev)
    with on_device(dev):
        rc = lib.hipac_augment_sums(imgs_u8.data_ptr(), sums.data_ptr(), b, n,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"augment sums kernel launch failed: cudaError {rc}")
    augment_batch_kernel.launches += 1

    md, biasd = augment_color(params, augment_means(sums, n))
    # the draws as the kernel reads them (no copy when they already are)
    h, v = (params[key].to(torch.bool).contiguous() for key in ("h", "v"))
    k = params["k"].to(torch.int64).contiguous()
    out = torch.empty(imgs_u8.shape, dtype=torch.float32, device=dev)
    with on_device(dev):
        rc = lib.hipac_augment_apply(
            imgs_u8.data_ptr(), h.data_ptr(), v.data_ptr(), k.data_ptr(),
            D4_PACKED, md.data_ptr(), biasd.data_ptr(), out.data_ptr(), b, s,
            INV_255_BF16, *MEAN_255, *STD_255, stream)
    if rc != 0:
        raise RuntimeError(f"augment apply kernel launch failed: cudaError {rc}")
    augment_batch_kernel.launches += 1
    return out


augment_batch_kernel.launches = 0
