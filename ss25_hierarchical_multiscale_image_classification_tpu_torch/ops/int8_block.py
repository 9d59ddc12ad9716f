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
the launches) and CPU tensors to the plain version
(:func:`fused_stage1_int8_reference`: the stage-1 loop of ``quant_forward``
over the plain convolution of ``ops/int8_conv.py``). The sums are integers
and the kernel's epilogue rounds where the eager ops round, so the two are
equal bit for bit. In the JAX package the kernel has no caller but its
test; here it is stage 1 of ``models/quantized.py::quant_forward``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
    int8_conv_reference,
    requant_reference,
)

_C = 64
#: Output rows per block of ``int8_block.cu``: bands of R + 8, R + 6 and
#: R + 4 rows live in shared memory, and 8/R of the rows are computed twice.
BAND_ROWS = 7
_PIXEL_BYTES = 80  # a band's pixel pitch in shared memory
_WEIGHT_BYTES = _C * (9 * _C + 16)  # one conv's weights in shared memory
# bytes a block may use on sm_90, less the weights: what the bands may take
_BAND_BUDGET = 232448 - _WEIGHT_BYTES
#: Widest plane whose bands (of one output row) fit shared memory.
MAX_WIDTH = _BAND_BUDGET // (21 * _PIXEL_BYTES) - 2
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
    """(4, 3, 3, C, C) HWIO per conv → (4, C, 9·C) int8, per conv
    ``[o][ky][kx][ci]``: the layout ``int8_block.cu`` reads."""
    c = kernels.shape[-1]
    return kernels.permute(0, 4, 1, 2, 3).reshape(4, c, 9 * c).contiguous()


def band_rows_for(width: int) -> int:
    """The output rows per block for a plane ``width`` wide: :data:`BAND_ROWS`
    if its three bands fit shared memory beside the weights, else the most
    that do."""
    fit = (_BAND_BUDGET // ((width + 2) * _PIXEL_BYTES) - 18) // 3
    if fit < 1:
        raise ValueError(f"the fused stage-1 kernel takes planes up to "
                         f"{MAX_WIDTH} wide, got {width}")
    return min(BAND_ROWS, fit)


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
    if tuple(packed.shape) != (4, _C, 9 * _C) or packed.dtype != torch.int8:
        raise ValueError(f"packed kernels of shape {tuple(packed.shape)} do "
                         f"not belong to this stage")
    if not all(t.is_contiguous() for t in (xq, packed, mscales, biases,
                                           scalars)):
        raise ValueError("the fused stage-1 kernel needs contiguous inputs")
    rows = band_rows_for(w)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty_like(xq)
    with torch.cuda.device(xq.device):
        rc = load_library().hipac_fused_stage1_int8(
            xq.data_ptr(), packed.data_ptr(), mscales.data_ptr(),
            biases.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, h, w,
            rows, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_stage1_int8 kernel launch failed: "
                           f"cudaError {rc}")
    fused_stage1_int8_kernel.launches += 1
    return out


fused_stage1_int8_kernel.launches = 0


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

    Returns (B, H, W, 64) int8 at activation scale ``scalars[4]``: the
    kernel's result for CUDA tensors, the plain version's for CPU tensors.
    """
    if xq.device.type == "cpu":
        return fused_stage1_int8_reference(xq, kernels, mscales, biases,
                                           scalars)
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
