"""The classifier's training augmentation as one hand-written CUDA kernel.

The JAX package's ``data/augment.py::augment_batch`` (D4 element, colour
affine, clip, ImageNet normalize) has no Pallas kernel: XLA fuses it into a
few passes inside the jitted train step. Eager PyTorch would run each of its
~15 operations as a pass over the batch, so the port's trainer runs it as
``ops/csrc/augment.cu``: one launch, a cluster of blocks an image, which
reads every input byte once, takes the image's exact byte sum over the
cluster, derives the mean and the contrast bias, and writes the normalized
float32 output through the image's D4 map. The colour matrix depends on the
draws only: :func:`augment_matrix` (plain PyTorch on (B,) vectors) makes it
before the launch.

For a CUDA tensor :func:`augment_batch_kernel` launches the kernel or
raises; ``augment_batch_kernel.launches`` counts each launch (one a call).
For a CPU tensor it takes ``data/augment.py::augment_batch``, the plain
version, which the CPU tests hold against the JAX function and which the
kernel must equal bit for bit.
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
    augment_matrix,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

#: bfloat16(1/255) as a float: the kernel's channel scale
INV_255_BF16 = torch.tensor(1.0 / 255.0, dtype=torch.bfloat16).item()

#: The D4 tables packed for the kernel: for the draws (h, v, k), 3 bits at
#: 3·(8h + 4v + k): transpose, x-reverse (·2), y-reverse (·4).
D4_PACKED = sum(
    int(_D4_T[h, v, k] + 2 * _D4_FX[h, v, k] + 4 * _D4_FY[h, v, k])
    << (3 * (8 * h + 4 * v + k))
    for h in range(2) for v in range(2) for k in range(4))


#: Blocks of the cluster that handles an image; block j owns the source
#: rows [j·R, (j+1)·R), R = ceil(S / CLUSTER).
CLUSTER = 8
#: Shared memory of a block ahead of its band, and at most in all (sm_90).
_HEADER_BYTES = 96 + 4 * 4 * 32 * 3 * 4
_MAX_SMEM = 232448


def band_rows(s: int) -> int:
    """R: the source rows of an image's band (the last bands may be
    shorter or empty)."""
    return -(-s // CLUSTER)


def band_pitch(s: int) -> int:
    """A band row's pitch in shared memory: 3·S bytes rounded up to an odd
    number of 16-byte units."""
    units = -(-3 * s // 16)
    return 16 * (units if units % 2 else units + 1)


#: The largest S whose band fits a block's shared memory.
MAX_SIZE = max(s for s in range(1, 2048)
               if _HEADER_BYTES + band_rows(s) * band_pitch(s) <= _MAX_SMEM)


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

    A CPU tensor takes the plain ``augment_batch`` at any S. A CUDA tensor
    must be contiguous, S ≤ :data:`MAX_SIZE` (the kernel's band of rows must
    fit a block's shared memory) and B ≤ 65535; the kernel launches on the
    current stream.
    """
    _check(params, imgs_u8)
    s = imgs_u8.shape[1]
    dev = imgs_u8.device
    if dev.type == "cpu":
        return augment_batch(params, imgs_u8)
    if dev.type != "cuda":
        raise ValueError(f"augment_batch_kernel runs on cuda or cpu, not {dev}")
    if s > MAX_SIZE:
        raise ValueError(f"augment_batch_kernel takes images of at most "
                         f"{MAX_SIZE}×{MAX_SIZE} pixels on the card, got "
                         f"{s}×{s}")
    if not imgs_u8.is_contiguous():
        raise ValueError("augment_batch_kernel needs a contiguous CUDA tensor")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        on_device,
    )

    lib = load_library()
    b = imgs_u8.shape[0]
    if b > 65535:
        raise ValueError(f"augment_batch_kernel takes at most 65535 images, "
                         f"got {b}")
    md = augment_matrix(params)
    # the draws as the kernel reads them (no copy when they already are)
    h, v = (params[key].to(torch.bool).contiguous() for key in ("h", "v"))
    k = params["k"]
    if k.dtype not in (torch.int32, torch.int64):
        k = k.to(torch.int64)
    k = k.contiguous()
    fb, fc = (params[key].to(torch.float32).contiguous()
              for key in ("fb", "fc"))
    out = torch.empty(imgs_u8.shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with on_device(dev):
        rc = lib.hipac_augment(
            imgs_u8.data_ptr(), h.data_ptr(), v.data_ptr(), k.data_ptr(),
            k.element_size() // 4, D4_PACKED, md.data_ptr(), fb.data_ptr(),
            fc.data_ptr(), out.data_ptr(), b, s, INV_255_BF16, *MEAN_255,
            *STD_255, stream)
    if rc != 0:
        raise RuntimeError(f"augment kernel launch failed: cudaError {rc}")
    count_launch(augment_batch_kernel)
    return out


augment_batch_kernel.launches = 0
