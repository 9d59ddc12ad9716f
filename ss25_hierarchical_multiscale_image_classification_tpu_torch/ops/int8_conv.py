"""int8 convolution with int32 accumulation and the requantization epilogue,
on a hand-written CUDA kernel: every convolution of the int8 (w8a8) forward.

Counterpart of ``_convq`` + ``_requant`` of the JAX package's
``models/quantized.py``. There the convolution is
``lax.conv_general_dilated`` on int8 operands with an int32 result and XLA
fuses the epilogue; PyTorch has no int8 convolution on CUDA, so the port
has a kernel of its own (``ops/csrc/int8_conv.cu``, the generalisation of the
fused stage-1 kernel of ``ops/int8_block.py``).

:func:`int8_conv_requant` computes, over NHWC int8 activations,

    acc = conv(xq, qkernel)                     # exact, int32
    y   = acc.float() * mscale + bias           # bias (C,) or an (H, W, C) map
    y   = y + residual                          # optional
    y   = relu(y)                               # optional
    out = clip(round(y / s_out), ±127).int8     # or y itself with out_f32

It sends CUDA tensors to the kernel (``int8_conv_requant_kernel.launches``
counts the launches) and CPU tensors to the plain version
(:func:`int8_conv_requant_reference`: an exact integer convolution, then the
epilogue in eager float32 ops), which the CPU tests hold against the JAX
functions and the card's checks hold the kernel against, bit for bit: the
sums are integers, and the kernel's epilogue rounds where the eager ops
round (no FMA contraction, IEEE quotient by a device scalar, half to even).

Weights are ``(C_out, C_in, KH, KW)`` int8; :func:`pack_int8_kernel` gives
the kernel's layout once (for the stage convolutions the shared-memory image
that the tensor cores read, :func:`wgmma_weight_image`), so that a forward
packs nothing per call. A stem's few input channels (12 after
space-to-depth; 3, padded with zeros to 4) are handled by zero padding, which
is exact (int8 0 is real 0.0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

#: Widest output plane (columns) one block of ``int8_conv.cu`` covers.
MAX_OUT_WIDTH = 128


def _pad4(pad) -> tuple[int, int, int, int]:
    """``pad`` as (top, bottom, left, right): an int, ((top, bottom), (left,
    right)) as the JAX convolutions take it, or the four already."""
    if isinstance(pad, int):
        return pad, pad, pad, pad
    if len(pad) == 4:
        return tuple(int(v) for v in pad)
    (top, bottom), (left, right) = pad
    return int(top), int(bottom), int(left), int(right)


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int,
            pad: tuple[int, int, int, int]) -> tuple[int, int]:
    return ((h + pad[0] + pad[1] - kh) // stride + 1,
            (w + pad[2] + pad[3] - kw) // stride + 1)


def _check(xq, qkernel, mscale, bias, s_out, stride, pad, residual,
           residual_scale, out_f32) -> tuple[int, int]:
    if xq.dim() != 4 or xq.dtype != torch.int8 or min(xq.shape) < 1:
        raise ValueError(f"expected a (B, H, W, C) int8 batch, got "
                         f"{tuple(xq.shape)} {xq.dtype}")
    if qkernel.dim() != 4 or qkernel.dtype != torch.int8 \
            or qkernel.shape[1] != xq.shape[3]:
        raise ValueError(f"expected (C_out, {xq.shape[3]}, KH, KW) int8 "
                         f"weights, got {tuple(qkernel.shape)} {qkernel.dtype}")
    c_out, _, kh, kw = qkernel.shape
    ho, wo = _out_hw(xq.shape[1], xq.shape[2], kh, kw, stride, pad)
    if stride < 1 or min(pad) < 0 or ho < 1 or wo < 1:
        raise ValueError(f"stride {stride}, pad {pad} leave no output plane")
    if tuple(mscale.shape) != (c_out,):
        raise ValueError(f"expected mscale of ({c_out},), got "
                         f"{tuple(mscale.shape)}")
    if tuple(bias.shape) not in ((c_out,), (ho, wo, c_out)):
        raise ValueError(f"expected a bias of ({c_out},) or ({ho}, {wo}, "
                         f"{c_out}), got {tuple(bias.shape)}")
    if not out_f32 and (s_out is None or s_out.numel() != 1):
        raise ValueError("s_out is one float32 value on the batch's device")
    if residual is not None:
        if tuple(residual.shape) != (xq.shape[0], ho, wo, c_out):
            raise ValueError(f"expected a residual of "
                             f"{(xq.shape[0], ho, wo, c_out)}, got "
                             f"{tuple(residual.shape)}")
        if residual.dtype == torch.int8:
            if residual_scale is None or residual_scale.numel() != 1:
                raise ValueError("an int8 residual needs its residual_scale")
        elif residual.dtype != torch.float32:
            raise ValueError("the residual is float32, or int8 with a scale")
    tensors = [qkernel, mscale, bias, s_out, residual, residual_scale]
    if any(t is not None and t.device != xq.device for t in tensors):
        raise ValueError(f"every tensor must lie on the batch's device "
                         f"{xq.device}")
    return ho, wo


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def int8_conv_reference(xq: torch.Tensor, qkernel: torch.Tensor, stride: int,
                        pad) -> torch.Tensor:
    """The exact integer convolution: (B, H, W, C_in) int8 and (C_out, C_in,
    KH, KW) int8 → (B, Ho, Wo, C_out) int32. On the CPU it is ``F.conv2d`` on
    int32 tensors. PyTorch has no integer convolution on CUDA; there it runs
    in float64 (every sum is an integer below 2⁵³, so exact in any order)
    through the im2col + GEMM route (cuDNN off: a transform-domain algorithm
    would leave the integers)."""
    top, bottom, left, right = _pad4(pad)
    x = F.pad(xq.permute(0, 3, 1, 2), (left, right, top, bottom))
    if xq.device.type == "cpu":
        y = F.conv2d(x.to(torch.int32), qkernel.to(torch.int32), None, stride)
        return y.permute(0, 2, 3, 1).contiguous()
    w = qkernel.to(torch.float64)
    parts = []
    with torch.backends.cudnn.flags(enabled=False):
        for chunk in x.split(64):  # bounds the float64 planes
            y = F.conv2d(chunk.to(torch.float64), w, None, stride)
            parts.append(y.permute(0, 2, 3, 1).to(torch.int32))
    return torch.cat(parts).contiguous()


def requant_reference(acc: torch.Tensor, mscale: torch.Tensor,
                      bias: torch.Tensor, s_out: torch.Tensor | None,
                      residual: torch.Tensor | None = None, relu: bool = True,
                      out_f32: bool = False) -> torch.Tensor:
    """The conv epilogue in eager float32 ops, as the JAX ``_requant``:
    int32 → float32, times ``mscale``, plus ``bias`` (+ ``residual``), ReLU,
    then ``round(y / s_out)`` clipped to ±127 as int8. ``s_out`` is a tensor
    on the device, so the division is the IEEE quotient on the card as well
    (by a host scalar PyTorch multiplies with the reciprocal there)."""
    y = acc.to(torch.float32) * mscale + bias
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    if out_f32:
        return y
    q = torch.round(y / s_out.reshape(()))
    return q.clamp(-127.0, 127.0).to(torch.int8)


def _residual_f32(residual, residual_scale):
    if residual is not None and residual.dtype == torch.int8:
        return residual.to(torch.float32) * residual_scale.reshape(())
    return residual


def int8_conv_requant_reference(
    xq: torch.Tensor, qkernel: torch.Tensor, mscale: torch.Tensor,
    bias: torch.Tensor, s_out: torch.Tensor | None, stride: int, pad,
    residual: torch.Tensor | None = None, relu: bool = True,
    out_f32: bool = False, residual_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`int8_conv_requant` on any device."""
    pad = _pad4(pad)
    _check(xq, qkernel, mscale, bias, s_out, stride, pad, residual,
           residual_scale, out_f32)
    acc = int8_conv_reference(xq, qkernel, stride, pad)
    return requant_reference(acc, mscale, bias, s_out,
                             _residual_f32(residual, residual_scale), relu,
                             out_f32)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


#: Input channels per ring stage of ``int8_conv.cu``'s ``wgmma`` path.
CHUNK = 32


def wgmma_block(c_out: int, taps: int) -> int:
    """Output channels per block (the ``wgmma`` N) for ``c_out`` channels and
    a kernel of ``taps`` = KH·KW: 128 where they divide C_out and two stages
    of the weights (taps · N · 32 bytes each) leave room in shared memory,
    else 64."""
    return 128 if c_out % 128 == 0 and taps <= 16 else 64


def wgmma_weight_image(w_ohwi: torch.Tensor, n_block: int) -> torch.Tensor:
    """(O, KH, KW, I) int8, O a multiple of ``n_block`` and I of 32 → the
    weights as the tensor cores read them from shared memory, ``(O / N, I /
    32, KH·KW·N·32)``: per block of N output channels and chunk of 32 input
    channels one contiguous image ``[tap][o / 8][half][o % 8][16]`` (tap = ky
    · KW + kx; half = which 16 of the chunk's 32 input channels). The cell
    ``[o / 8][half]`` is a core matrix of a K-major ``wgmma`` operand without
    swizzle, 8 channels × 16 bytes stored as 128 contiguous bytes; the two
    halves lie 128 bytes apart, groups of 8 channels 256. So one bulk copy
    per (block, chunk) lands a ring stage's weights ready for a matrix
    descriptor."""
    o, kh, kw, i = w_ohwi.shape
    if o % n_block or n_block % 8 or i % CHUNK:
        raise ValueError(f"a weight image takes C_out in multiples of "
                         f"{n_block} and C_in in multiples of {CHUNK}, got "
                         f"{o}, {i}")
    w = w_ohwi.reshape(o // n_block, n_block // 8, 8, kh * kw, i // CHUNK, 2, 16)
    # (block, group, row, tap, chunk, half, byte) → (block, chunk, tap, group,
    # half, row, byte)
    w = w.permute(0, 4, 3, 1, 5, 2, 6)
    return w.contiguous().reshape(o // n_block, i // CHUNK,
                                  kh * kw * n_block * CHUNK)


def packed_shape(c_out: int, c_in: int, kh: int, kw: int) -> tuple[int, ...]:
    """Shape of :func:`pack_int8_kernel`'s result (``c_in`` as the kernel
    sees it: a stem's channels padded to a multiple of 4)."""
    if c_in % 64 == 0:
        n = wgmma_block(c_out, kh * kw)
        return c_out // n, c_in // CHUNK, kh * kw * n * CHUNK
    return c_out, kh, -(-kw * c_in // 32) * 32


def pack_int8_kernel(qkernel: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, KH, KW) int8 → the weights as ``int8_conv.cu`` reads
    them. For C_in a multiple of 64 that is :func:`wgmma_weight_image` with
    blocks of :func:`wgmma_block` output channels; for a stem (C_in ≤ 16,
    padded with zero channels to a multiple of 4) ``[o][ky][row]`` with the
    row ``[kx][ci]`` zero-filled to a multiple of 32 bytes."""
    c_out, c_in, kh, kw = qkernel.shape
    w = qkernel.permute(0, 2, 3, 1)  # (O, KH, KW, I)
    if c_in % 64 == 0:
        if c_out % 64:
            raise ValueError(f"the int8 conv kernel takes C_out in multiples "
                             f"of 64, got {c_out}")
        return wgmma_weight_image(w, wgmma_block(c_out, kh * kw))
    if c_in > 16:
        raise ValueError(f"the int8 conv kernel takes C_in in multiples of "
                         f"64, or a stem of at most 16 channels, got {c_in}")
    cp = -(-c_in // 4) * 4
    row = -(-kw * cp // 32) * 32
    w = F.pad(w, (0, cp - c_in)).reshape(c_out, kh, kw * cp)
    return F.pad(w, (0, row - kw * cp)).contiguous()


def int8_conv_requant_kernel(
    xq: torch.Tensor, qkernel: torch.Tensor, mscale: torch.Tensor,
    bias: torch.Tensor, s_out: torch.Tensor | None, stride: int, pad,
    residual: torch.Tensor | None = None, relu: bool = True,
    out_f32: bool = False, residual_scale: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors: C_out a multiple of 64,
    C_in a multiple of 64 or at most 16, an output plane at most
    :data:`MAX_OUT_WIDTH` wide, float32 ``mscale``/``bias``/``s_out``.
    ``packed`` is :func:`pack_int8_kernel` of ``qkernel`` (made here if not
    given). Raises on anything else."""
    pad = _pad4(pad)
    ho, wo = _check(xq, qkernel, mscale, bias, s_out, stride, pad, residual,
                    residual_scale, out_f32)
    if xq.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, not "
                         f"{xq.device}")
    b, h, w, c_in = xq.shape
    c_out, _, kh, kw = qkernel.shape
    if c_out % 64:
        raise ValueError(f"the int8 conv kernel takes C_out in multiples of "
                         f"64, got {c_out}")
    if wo > MAX_OUT_WIDTH:
        raise ValueError(f"the int8 conv kernel takes output planes up to "
                         f"{MAX_OUT_WIDTH} wide, got {wo}")
    if packed is None:
        packed = pack_int8_kernel(qkernel)
    if c_in % 64 and c_in % 4:  # a stem's 3 channels: one zero channel more
        xq = F.pad(xq, (0, 4 - c_in % 4))
        c_in = xq.shape[3]
    if packed.dtype != torch.int8 \
            or tuple(packed.shape) != packed_shape(c_out, c_in, kh, kw):
        raise ValueError(f"packed weights of shape {tuple(packed.shape)} do "
                         f"not belong to this convolution")
    floats = [mscale, bias] + [t for t in (s_out, residual_scale)
                               if t is not None]
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("mscale, bias, s_out and residual_scale are float32")
    tensors = [xq, packed, mscale, bias] + ([residual] if residual is not None
                                            else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the int8 conv kernel needs contiguous inputs")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty(b, ho, wo, c_out, device=xq.device,
                      dtype=torch.float32 if out_f32 else torch.int8)
    res_kind = 0 if residual is None else (2 if residual.dtype == torch.int8
                                           else 1)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(xq.device):
        rc = load_library().hipac_int8_conv_requant(
            xq.data_ptr(), packed.data_ptr(), mscale.data_ptr(),
            bias.data_ptr(), int(bias.dim() == 3), ptr(s_out), ptr(residual),
            res_kind, ptr(residual_scale), out.data_ptr(), int(out_f32),
            int(relu), b, h, w, c_in, c_out, kh, kw, stride, pad[0], pad[2],
            ho, wo, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {rc}")
    count_launch(int8_conv_requant_kernel)
    return out


int8_conv_requant_kernel.launches = 0


def int8_conv_requant(
    xq: torch.Tensor, qkernel: torch.Tensor, mscale: torch.Tensor,
    bias: torch.Tensor, s_out: torch.Tensor | None, stride: int, pad,
    residual: torch.Tensor | None = None, relu: bool = True,
    out_f32: bool = False, residual_scale: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """int8 convolution + requantization: (B, H, W, C_in) int8 → (B, Ho, Wo,
    C_out) int8 (or float32 with ``out_f32``).

    Args:
        xq: NHWC int8 activations.
        qkernel: (C_out, C_in, KH, KW) int8 weights.
        mscale: (C_out,) float32, input activation scale × weight scale.
        bias: (C_out,) float32, or an (Ho, Wo, C_out) map (the folded stem).
        s_out: one float32 on the device, the output activation scale
            (ignored with ``out_f32``).
        stride, pad: ``pad`` an int or ((top, bottom), (left, right)).
        residual: (B, Ho, Wo, C_out) float32 added before the ReLU, or int8
            activations multiplied by ``residual_scale`` (one float32 on the
            device) on the way: the same numbers without a float32 plane in
            device memory.
        relu, out_f32: the downsample convolutions take ``relu=False,
            out_f32=True`` and return the dequantized float32 plane.
        packed: :func:`pack_int8_kernel` of ``qkernel``, for the kernel.

    The kernel's result for CUDA tensors, the plain version's for CPU
    tensors.
    """
    if xq.device.type == "cpu":
        return int8_conv_requant_reference(xq, qkernel, mscale, bias, s_out,
                                           stride, pad, residual, relu,
                                           out_f32, residual_scale)
    return int8_conv_requant_kernel(
        xq.contiguous(), qkernel, mscale.contiguous(), bias.contiguous(),
        s_out, stride, pad, None if residual is None else residual.contiguous(),
        relu, out_f32, residual_scale, packed)
