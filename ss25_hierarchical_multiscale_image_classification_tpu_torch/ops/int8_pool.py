"""3×3 stride-2 maxpool (pad 1) over NHWC int8 activations on a hand-written
CUDA kernel: the pool between the stem and stage 1 of the int8 forward.

Counterpart of the ``lax.reduce_window`` on int8 (pad −128) in the JAX
package's ``models/quantized.py::quant_forward``, which XLA compiles; the JAX
package has no kernel of its own for it. PyTorch's ``max_pool2d`` takes no
int8 tensor on CUDA (and on the CPU indexes in the input's type), so the
plain version (:func:`int8_maxpool_reference`) pools in a float type that
holds every int8 value exactly and casts back: three passes and seven times
the bytes on the card, which is why the port has a kernel
(``ops/csrc/int8_pool.cu``; ``int8_maxpool_kernel.launches`` counts the
launches). Maxima of integers: the two are equal bit for bit.

The requantization and the ReLU before the pool are monotone, so pooling the
int8 plane equals pooling before them, as the JAX forward notes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype != torch.int8 or min(x.shape) < 1:
        raise ValueError(f"expected a (B, H, W, C) int8 plane, got "
                         f"{tuple(x.shape)} {x.dtype}")


def int8_maxpool_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the pool in bfloat16 on the card and float32 on the
    CPU (both hold every int8 value exactly), cast back to int8. A window
    always holds a real element, so the pad (−128 in the JAX forward, −inf
    here) never wins."""
    _check(x)
    dtype = torch.bfloat16 if x.device.type == "cuda" else torch.float32
    y = F.max_pool2d(x.permute(0, 3, 1, 2).to(dtype), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def int8_maxpool_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA plane (B, H, W, C) int8, C a
    multiple of 16. Raises on anything else."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"the int8 maxpool kernel runs on CUDA tensors, not "
                         f"{x.device}")
    b, h, w, c = x.shape
    if c % 16:
        raise ValueError(f"the int8 maxpool kernel takes channels in "
                         f"multiples of 16, got {c}")
    if not x.is_contiguous():
        raise ValueError("the int8 maxpool kernel needs a contiguous plane")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty(b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c,
                      dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = load_library().hipac_int8_maxpool(
            x.data_ptr(), out.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 maxpool kernel launch failed: cudaError {rc}")
    count_launch(int8_maxpool_kernel)
    return out


int8_maxpool_kernel.launches = 0


def int8_maxpool(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 maxpool, pad 1, over (B, H, W, C) int8 → (B, ⌈H/2⌉,
    ⌈W/2⌉, C) int8: the kernel's result for CUDA tensors, the plain
    version's for CPU tensors."""
    if x.device.type == "cpu":
        return int8_maxpool_reference(x)
    return int8_maxpool_kernel(x.contiguous())
