"""Fused int8 ResNet stage 1 on a hand-written CUDA kernel: both 64-channel
BasicBlocks, one launch, one read and one write of the activation plane.

Counterpart of the JAX package's ``ops/pallas/int8_block.py``
(``fused_stage1_int8``, ``stage1_params_from_qtree``), with its arguments
and its NHWC layout: four 3×3 int8 convolutions with int32 accumulation,
each followed by dequantize · ``mscale`` + bias (+ the block's input · its
scale) → ReLU → ``round(y / s_out)`` clipped to ±127 → int8, with every
intermediate plane zero-padded as the reference pads it.

:func:`fused_stage1_int8` sends CUDA tensors to the kernel
(``ops/csrc/int8_block.cu``; ``fused_stage1_int8_kernel.launches`` counts
the launches) when a cluster of blocks holds the plane, else to the four
exact convolutions of ``ops/int8_conv.py`` (:func:`stage1_route`), and CPU
tensors to the plain version
(:func:`fused_stage1_int8_reference`: the stage-1 loop of ``quant_forward``
over the plain convolution of ``ops/int8_conv.py``). The sums are integers
and the kernel's epilogue rounds where the eager ops round, so the two are
equal bit for bit. In the JAX package the kernel has no caller but its
test; here it is stage 1 of ``models/quantized.py::quant_forward``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Mapping

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
    int8_conv_reference,
    int8_conv_requant,
    requant_reference,
    wgmma_weight_image,
)

_C = 64
#: Blocks of the largest thread-block cluster ``int8_block.cu`` gives an image.
MAX_CLUSTER = 8
#: Rows per block up to which an image takes a smaller cluster.
SLAB_ROWS = 8
_PIXEL_BYTES = 80  # a slab's pixel pitch in shared memory
_WEIGHT_BYTES = 9 * _C * _C  # one conv's weight image in shared memory
# bytes a block may use on sm_90, less two weight images: what the three
# slabs (R + 2 rows each, one pad column each side) and the table of R · W
# pixel offsets may take
_SLAB_BUDGET = 232448 - 2 * _WEIGHT_BYTES
#: Widest plane whose slabs (of one row a block) fit shared memory.
MAX_WIDTH = (_SLAB_BUDGET - 2 * 3 * 3 * _PIXEL_BYTES) // (3 * 3 * _PIXEL_BYTES + 4)
_NAMES = ("s1b0c1", "s1b0c2", "s1b1c1", "s1b1c2")


def _check(xq, kernels, mscales, biases, scalars) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8 or min(xq.shape) < 1:
        raise ValueError(f"expected a (B, H, W, C) int8 batch, got "
                         f"{tuple(xq.shape)} {xq.dtype}")
    c = xq.shape[3]
    if tuple(kernels.shape) != (4, 3, 3, c, c) or kernels.dtype != torch.int8:
        raise ValueError(f"expected (4, 3, 3, {c}, {c}) int8 kernels (HWIO per "
                         f"conv), got {tuple(kernels.shape)} {kernels.dtype}")
    if tuple(mscales.shape) != (4, c) or tuple(biases.shape) != (4, c) \
            or tuple(scalars.shape) != (5,):
        raise ValueError(f"expected mscales and biases of (4, {c}) and "
                         f"scalars of (5,), got {tuple(mscales.shape)}, "
                         f"{tuple(biases.shape)}, {tuple(scalars.shape)}")
    others = (kernels, mscales, biases, scalars)
    if any(t.device != xq.device for t in others):
        raise ValueError(f"every tensor must lie on the batch's device "
                         f"{xq.device}")


def fused_stage1_int8_reference(xq: torch.Tensor, kernels: torch.Tensor,
                                mscales: torch.Tensor, biases: torch.Tensor,
                                scalars: torch.Tensor) -> torch.Tensor:
    """Plain version: the stage-1 loop of ``quant_forward`` (two blocks of
    conv → requant → conv → requant with the block's input as residual) over
    the exact integer convolution and the eager float32 epilogue. Any channel
    count."""
    _check(xq, kernels, mscales, biases, scalars)
    x = xq
    for blk in range(2):
        c1, c2 = 2 * blk, 2 * blk + 1
        s_x, s_y1, s_o = scalars[2 * blk], scalars[1 + 2 * blk], scalars[2 + 2 * blk]
        # HWIO → OIHW
        acc = int8_conv_reference(x, kernels[c1].permute(3, 2, 0, 1), 1, 1)
        y1 = requant_reference(acc, mscales[c1], biases[c1], s_y1)
        acc = int8_conv_reference(y1, kernels[c2].permute(3, 2, 0, 1), 1, 1)
        res = x.to(torch.float32) * s_x
        x = requant_reference(acc, mscales[c2], biases[c2], s_o, residual=res)
    return x


def pack_stage1_kernels(kernels: torch.Tensor) -> torch.Tensor:
    """(4, 3, 3, 64, 64) HWIO per conv → (4, 36864) int8, per conv the
    shared-memory image ``int8_block.cu`` hands the tensor cores
    (:func:`~.int8_conv.wgmma_weight_image` with one block of 64 output
    channels: ``[ci / 32][ky·3 + kx][o / 8][half][o % 8][16]``)."""
    if tuple(kernels.shape) != (4, 3, 3, _C, _C):
        raise ValueError(f"the fused stage-1 kernel takes (4, 3, 3, {_C}, "
                         f"{_C}) kernels, got {tuple(kernels.shape)}")
    ohwi = kernels.permute(0, 4, 1, 2, 3)
    return torch.stack([wgmma_weight_image(k, _C).reshape(-1) for k in ohwi])


def _slab_bytes(rows: int, width: int) -> int:
    """Shared memory of a block's three slabs of ``rows + 2`` rows and its
    table of ``rows · width`` pixel offsets."""
    return 3 * (rows + 2) * (width + 2) * _PIXEL_BYTES + 4 * rows * width


def _smallest_cluster(height: int, width: int) -> tuple[int, int]:
    """The smallest power of two of blocks, at most :data:`MAX_CLUSTER`, that
    leaves a block at most :data:`SLAB_ROWS` rows whose slabs fit, and the
    rows each owns (the slabs of the largest cluster may still not fit)."""
    cluster = 1
    while cluster < MAX_CLUSTER and (
            -(-height // cluster) > SLAB_ROWS
            or _slab_bytes(-(-height // cluster), width) > _SLAB_BUDGET):
        cluster *= 2
    return cluster, -(-height // cluster)


def cluster_plan(height: int, width: int) -> tuple[int, int]:
    """``(cluster, rows)`` for a plane: the blocks of the cluster that holds
    an image and the rows each owns. The smallest power of two of blocks that
    leaves a block at most :data:`SLAB_ROWS` rows and fits three slabs of
    ``rows + 2`` rows into its shared memory beside two weight images, at
    most :data:`MAX_CLUSTER`. Raises for a plane no such cluster holds
    (:func:`stage1_route` sends those to the convolutions)."""
    cluster, rows = _smallest_cluster(height, width)
    if _slab_bytes(rows, width) > _SLAB_BUDGET:
        raise ValueError(
            f"the fused stage-1 kernel holds an image in the shared memory "
            f"of {MAX_CLUSTER} blocks: planes up to {MAX_WIDTH} wide with 3 · "
            f"(R + 2) · (W + 2) · {_PIXEL_BYTES} + 4 · R · W ≤ {_SLAB_BUDGET} "
            f"bytes for R = ceil(H / {MAX_CLUSTER}), got {height} × {width}")
    return cluster, rows


def stage1_route(height: int, width: int) -> str:
    """How a CUDA plane of ``height`` × ``width`` runs stage 1, decided by
    its shape alone: ``"block"``, the fused kernel, when a cluster of at most
    :data:`MAX_CLUSTER` blocks holds the image (:func:`cluster_plan`; planes
    up to 63 × 63, inputs up to 252²); else ``"convs"``, the four
    convolutions one ``int8_conv_requant`` launch each
    (:func:`fused_stage1_int8_convs`; 64 × 64, a 256² input, and up). Both
    routes are exact, so both give the plain version's bits."""
    cluster, rows = _smallest_cluster(height, width)
    return "block" if _slab_bytes(rows, width) <= _SLAB_BUDGET else "convs"


def fused_stage1_int8_convs(xq: torch.Tensor, kernels: torch.Tensor,
                            mscales: torch.Tensor, biases: torch.Tensor,
                            scalars: torch.Tensor) -> torch.Tensor:
    """Stage 1 as four :func:`~.int8_conv.int8_conv_requant` calls, the
    plain version's loop with each convolution and its epilogue on the int8
    conv kernel (CUDA tensors) or its plain version (CPU tensors): the
    second convolution of a block takes the block's int8 input as its
    residual at scale ``s_x``. The weights are packed for the kernel per
    call."""
    _check(xq, kernels, mscales, biases, scalars)
    x = xq
    for blk in range(2):
        c1, c2 = 2 * blk, 2 * blk + 1
        s_x, s_y1, s_o = scalars[2 * blk], scalars[1 + 2 * blk], scalars[2 + 2 * blk]
        # HWIO → OIHW
        y1 = int8_conv_requant(x, kernels[c1].permute(3, 2, 0, 1), mscales[c1],
                               biases[c1], s_y1, 1, 1)
        x = int8_conv_requant(y1, kernels[c2].permute(3, 2, 0, 1), mscales[c2],
                              biases[c2], s_o, 1, 1, residual=x,
                              residual_scale=s_x)
    return x


def fused_stage1_int8_kernel(xq: torch.Tensor, kernels: torch.Tensor,
                             mscales: torch.Tensor, biases: torch.Tensor,
                             scalars: torch.Tensor,
                             packed: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors: (B, H, W, 64) int8,
    float32 ``mscales``, ``biases`` and ``scalars``. ``packed`` is
    :func:`pack_stage1_kernels` of ``kernels`` (made here if not given).
    Raises on anything else."""
    _check(xq, kernels, mscales, biases, scalars)
    if xq.device.type != "cuda":
        raise ValueError(f"the fused stage-1 kernel runs on CUDA tensors, not "
                         f"{xq.device}")
    b, h, w, c = xq.shape
    if c != _C:
        raise ValueError(f"the fused stage-1 kernel takes {_C} channels, got "
                         f"{c}")
    if any(t.dtype != torch.float32 for t in (mscales, biases, scalars)):
        raise ValueError("mscales, biases and scalars are float32")
    if packed is None:
        packed = pack_stage1_kernels(kernels)
    if tuple(packed.shape) != (4, _WEIGHT_BYTES) or packed.dtype != torch.int8:
        raise ValueError(f"packed kernels of shape {tuple(packed.shape)} do "
                         f"not belong to this stage")
    if not all(t.is_contiguous() for t in (xq, packed, mscales, biases,
                                           scalars)):
        raise ValueError("the fused stage-1 kernel needs contiguous inputs")
    cluster, rows = cluster_plan(h, w)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty_like(xq)
    with torch.cuda.device(xq.device):
        rc = load_library().hipac_fused_stage1_int8(
            xq.data_ptr(), packed.data_ptr(), mscales.data_ptr(),
            biases.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, h, w,
            rows, cluster, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_stage1_int8 kernel launch failed: "
                           f"cudaError {rc}")
    count_launch(fused_stage1_int8_kernel)
    return out


fused_stage1_int8_kernel.launches = 0


def active_clusters(height: int, width: int) -> int:
    """How many of the kernel's clusters the current card runs at once for a
    plane (``cudaOccupancyMaxActiveClusters``); builds the kernels."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    cluster, rows = cluster_plan(height, width)
    count = ctypes.c_int(0)
    rc = load_library().hipac_fused_stage1_int8_active_clusters(
        height, width, rows, cluster, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {rc}")
    return count.value


def fused_stage1_int8(xq: torch.Tensor, kernels: torch.Tensor,
                      mscales: torch.Tensor, biases: torch.Tensor,
                      scalars: torch.Tensor,
                      packed: torch.Tensor | None = None) -> torch.Tensor:
    """Run both stage-1 residual blocks fused.

    Args:
        xq: (B, H, W, 64) int8, the stage's input at scale ``scalars[0]``.
        kernels: (4, 3, 3, 64, 64) int8, HWIO per conv: s1b0c1, s1b0c2,
            s1b1c1, s1b1c2.
        mscales: (4, 64) float32, the conv's input activation scale × its
            per-channel weight scale.
        biases: (4, 64) float32, the BN-folded biases.
        scalars: (5,) float32, [s_x, s_y1_b0, s_o_b0, s_y1_b1, s_o_b1].
        packed: :func:`pack_stage1_kernels` of ``kernels``, for the kernel.

    Returns (B, H, W, 64) int8 at activation scale ``scalars[4]``: for CUDA
    tensors the fused kernel's result, or for a plane no cluster holds
    (:func:`stage1_route`) that of four ``int8_conv_requant`` launches; the
    plain version's for CPU tensors.
    """
    if xq.device.type == "cpu":
        return fused_stage1_int8_reference(xq, kernels, mscales, biases,
                                           scalars)
    if stage1_route(xq.shape[1], xq.shape[2]) == "convs":
        return fused_stage1_int8_convs(xq.contiguous(), kernels,
                                       mscales.contiguous(),
                                       biases.contiguous(),
                                       scalars.contiguous())
    return fused_stage1_int8_kernel(xq.contiguous(), kernels,
                                    mscales.contiguous(), biases.contiguous(),
                                    scalars.contiguous(), packed)


def stage1_params_from_qtree(qp: Mapping[str, Any]):
    """Package the stage-1 parameters of a quantized tree
    (``models/quantized.py``) for :func:`fused_stage1_int8`: ``(kernels,
    mscales, biases, scalars)`` with the activation scales multiplied in, as
    the JAX function returns them (kernels HWIO per conv)."""
    qk, ws, bs, sc = qp["qkernels"], qp["wscales"], qp["biases"], qp["ascales"]
    # the tree keeps (O, I, KH, KW); the kernels' argument is HWIO
    kernels = torch.stack([qk[n].permute(2, 3, 1, 0) for n in _NAMES])
    s_x = sc["p0"]
    s_y1_b0, s_o_b0 = sc["s1b0y1"], sc["s1b0o"]
    s_y1_b1, s_o_b1 = sc["s1b1y1"], sc["s1b1o"]
    mscales = torch.stack([
        s_x * ws["s1b0c1"],
        s_y1_b0 * ws["s1b0c2"],
        s_o_b0 * ws["s1b1c1"],
        s_y1_b1 * ws["s1b1c2"],
    ])
    biases = torch.stack([bs[n] for n in _NAMES])
    scalars = torch.stack([s_x, s_y1_b0, s_o_b0, s_y1_b1, s_o_b1])
    return kernels.contiguous(), mscales, biases, scalars
