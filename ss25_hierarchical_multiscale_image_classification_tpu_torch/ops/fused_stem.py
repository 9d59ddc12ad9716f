"""The ResNet stem on hand-written CUDA kernels: the whole stem in one pass
(:func:`fused_stem`), or the stem's epilogue after a library convolution
(:func:`bias_relu_pool`).

Counterpart of the JAX package's ``ops/pallas/fused_stem.py`` (``fused_stem``
with ``fold_stem_params``, ``stem_space_to_depth`` and ``stem_forward``;
``bias_relu_pool`` with ``stem_forward_hybrid``), with its names and its
NHWC layout.

- :func:`bias_relu_pool` adds a bias, applies ReLU and the overlapping 3×3
  stride-2 maxpool (pad 1) to a conv output (B, H, W, C) in one pass.
  Beyond the JAX kernel it takes any plane with C a multiple of 8 and a bias
  that is (C,) **or a per-position (H, W, C) map**: the map is the
  ``stem_bias_map`` of the folded inference forward
  (``models/quantized.py``), whose stem epilogue this kernel is.
- :func:`fused_stem` computes the stem's 7×7/2 convolution as a 4×4 stride-1
  convolution over a 2×2 space-to-depth input (K = 192) in its own body
  (bfloat16 products on ``wgmma`` from a weight image packed once,
  :func:`pack_stem_weights`; float32 products on FMAs), then the same
  epilogue, and writes only the pooled plane.

Each sends a CUDA tensor to its kernel (``ops/csrc/bias_relu_pool.cu``,
``ops/csrc/fused_stem.cu``; ``bias_relu_pool_kernel.launches`` and
``fused_stem_kernel.launches`` count the launches) and a CPU tensor to its
plain PyTorch version (``bias_relu_pool_reference``,
``fused_stem_reference``), which the CPU tests hold against the JAX kernels
and the card's checks hold the kernels against. ``bias_relu_pool`` is one
float32 add and comparisons, so its kernel equals the plain version exactly.

The pool is the true maxpool (−inf padding; a pad never wins). The JAX
``bias_relu_pool`` writes ``(−bias)`` in the plane's dtype into its pad row,
which in bfloat16 is rounded and can win over an all-zero window; compare
with it in float32, where that trick is exact.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

_DTYPES = (torch.float32, torch.bfloat16)
#: Widest conv plane (columns) ``fused_stem.cu`` takes.
MAX_CONV_WIDTH = 128
#: Pooled rows per block of the float32 (FMA) kernel of ``fused_stem.cu``;
#: its first conv row is computed twice, 1/(2·POOL_ROWS) extra work.
POOL_ROWS = 14
#: The bfloat16 (wgmma) kernel of ``fused_stem.cu``: slots of its input-row
#: ring, the dynamic shared memory a block may use, the pooled columns one
#: warp writes, the elements of a column of its bias band (64 + 8 against
#: bank conflicts) and the bytes of its weight image (``kRing``,
#: ``kSmemBudget``, ``kPoolsPerWarp``, ``kBiasPitch``, ``kWImgBytes``).
RING_SLOTS = 8
SMEM_BUDGET = 232448 - 256
POOLS_PER_WARP = 7
BIAS_PITCH = 72
W_IMAGE_BYTES = 12 * 64 * 16 * 2


def _pooled(n: int) -> int:
    return (n - 1) // 2 + 1


# ---------------------------------------------------------------------------
# bias + ReLU + maxpool (2b)
# ---------------------------------------------------------------------------


def _check_pool(conv_out: torch.Tensor, bias: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    if conv_out.dim() != 4 or min(conv_out.shape) < 1:
        raise ValueError(f"expected a (B, H, W, C) plane, got "
                         f"{tuple(conv_out.shape)}")
    _, h, w, c = conv_out.shape
    if tuple(bias.shape) not in ((c,), (h, w, c)):
        raise ValueError(f"expected a bias of ({c},) or ({h}, {w}, {c}), got "
                         f"{tuple(bias.shape)}")
    if conv_out.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError("the plane and the output are float32 or bfloat16")
    if bias.device != conv_out.device:
        raise ValueError(f"plane on {conv_out.device}, bias on {bias.device}")


def _max_pool(y: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 maxpool, pad 1 with −inf, over an NHWC tensor."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def bias_relu_pool_reference(conv_out: torch.Tensor, bias: torch.Tensor,
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """Plain version: float32 add, ReLU, maxpool, one cast."""
    _check_pool(conv_out, bias, out_dtype)
    y = (conv_out.float() + bias.float()).relu()
    return _max_pool(y).to(out_dtype).contiguous()


def bias_relu_pool_kernel(conv_out: torch.Tensor, bias: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA plane (B, H, W, C), C a
    multiple of 8, in float32 or bfloat16, with a contiguous float32 bias of
    (C,) or (H, W, C). Raises on anything else."""
    _check_pool(conv_out, bias, out_dtype)
    if conv_out.device.type != "cuda":
        raise ValueError(f"the bias_relu_pool kernel runs on CUDA tensors, "
                         f"not {conv_out.device}")
    b, h, w, c = conv_out.shape
    if c % 8:
        raise ValueError(f"the bias_relu_pool kernel takes channels in "
                         f"multiples of 8, got {c}")
    if bias.dtype != torch.float32:
        raise ValueError("the bias_relu_pool kernel takes a float32 bias")
    if not (conv_out.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the bias_relu_pool kernel needs contiguous inputs")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty(b, _pooled(h), _pooled(w), c, dtype=out_dtype,
                      device=conv_out.device)
    with torch.cuda.device(conv_out.device):
        rc = load_library().hipac_bias_relu_pool(
            conv_out.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c,
            int(bias.dim() == 3), int(conv_out.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bias_relu_pool kernel launch failed: "
                           f"cudaError {rc}")
    count_launch(bias_relu_pool_kernel)
    return out


bias_relu_pool_kernel.launches = 0


def bias_relu_pool(conv_out: torch.Tensor, bias: torch.Tensor,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused bias + ReLU + 3×3/2 maxpool over (B, H, W, C) → (B, ⌈H/2⌉,
    ⌈W/2⌉, C) in ``out_dtype``, the counterpart of the JAX
    ``bias_relu_pool``. ``bias`` is (C,) or an (H, W, C) map. The kernel's
    result for CUDA tensors, the plain version's for CPU tensors."""
    if conv_out.device.type == "cpu":
        return bias_relu_pool_reference(conv_out, bias, out_dtype)
    return bias_relu_pool_kernel(conv_out.contiguous(),
                                 bias.float().contiguous(), out_dtype)


# ---------------------------------------------------------------------------
# whole stem (2c)
# ---------------------------------------------------------------------------


def fold_stem_params(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into ``(w2, bias)``.

    ``conv_kernel`` is (7, 7, 3, C) HWIO as in the JAX package. Returns
    ``w2`` (4, 48, C) float32, the 4×4×12 space-to-depth kernel in KX-major
    groups with row ``KY·12 + (dy·2+dx)·3 + c`` (tap ``ky = 2·KY + dy``), and
    the folded BN shift ``bias`` (C,). The input normalization is not folded
    here: :func:`stem_space_to_depth` applies it before the zero padding.
    """
    w = torch.as_tensor(conv_kernel, dtype=torch.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(w.device)  # noqa: E731
    gamma = f32(bn_scale) * torch.rsqrt(f32(bn_var) + eps)
    w = w * gamma
    bias = f32(bn_bias) - f32(bn_mean) * gamma
    c_out = w.shape[-1]
    w8 = torch.zeros(8, 8, 3, c_out, dtype=torch.float32, device=w.device)
    w8[:7, :7] = w
    # (2·KY+dy, 2·KX+dx, c, o) → (KX, KY, dy, dx, c, o)
    w2 = w8.reshape(4, 2, 4, 2, 3, c_out).permute(2, 0, 1, 3, 4, 5)
    return w2.reshape(4, 48, c_out).contiguous(), bias


def stem_space_to_depth(imgs_u8: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8, H and W even → (B, H/2+3, W/2+3, 12): ImageNet
    normalized, zero-padded by 3 in normalized space, then cut into 2×2
    cells with slot ``(dy·2+dx)·3 + c``. Cell Y holds image rows 2Y−3 and
    2Y−2. The affine is ``x·a + b`` with ``a = (1/255)/std``, ``b =
    −mean/std`` in ``dtype``, as the JAX function computes it."""
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4 or imgs_u8.shape[-1] != 3:
        raise ValueError(f"expected a (B, H, W, 3) uint8 tensor, got "
                         f"{tuple(imgs_u8.shape)} {imgs_u8.dtype}")
    b, h, w, _ = imgs_u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs even H and W, got {h}×{w}")
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    a = torch.from_numpy(np.float32(1.0 / 255.0) / std).to(imgs_u8.device, dtype)
    off = torch.from_numpy(-mean / std).to(imgs_u8.device, dtype)
    x = imgs_u8.to(dtype) * a + off
    x = F.pad(x, (0, 0, 3, 3, 3, 3))
    x = x.reshape(b, h // 2 + 3, 2, w // 2 + 3, 2, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2 + 3, w // 2 + 3, 12)


def _check_stem(in2: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                out_dtype: torch.dtype, mm_dtype: torch.dtype) -> None:
    if in2.dim() != 4 or in2.shape[-1] != 12 or in2.shape[0] < 1 \
            or in2.shape[1] < 4 or in2.shape[2] < 4:
        raise ValueError(f"expected a (B, Hc+3, Wc+3, 12) space-to-depth "
                         f"input, got {tuple(in2.shape)}")
    if w2.dim() != 3 or w2.shape[:2] != (4, 48):
        raise ValueError(f"expected w2 of (4, 48, C), got {tuple(w2.shape)}")
    hc, wc, c = in2.shape[1] - 3, in2.shape[2] - 3, w2.shape[2]
    if tuple(bias.shape) not in ((c,), (hc, wc, c)):
        raise ValueError(f"expected a bias of ({c},) or ({hc}, {wc}, {c}), "
                         f"got {tuple(bias.shape)}")
    if in2.dtype not in _DTYPES or out_dtype not in _DTYPES \
            or mm_dtype not in _DTYPES:
        raise ValueError("input, output and product types are float32 or "
                         "bfloat16")
    if w2.device != in2.device or bias.device != in2.device:
        raise ValueError(f"in2 on {in2.device}, w2 on {w2.device}, bias on "
                         f"{bias.device}")


def fused_stem_reference(in2: torch.Tensor, w2: torch.Tensor,
                         bias: torch.Tensor,
                         out_dtype: torch.dtype = torch.bfloat16,
                         mm_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Plain version: the input and the weights rounded to ``mm_dtype``, a
    float32 4×4 VALID convolution of them (the arithmetic of an ``mm_dtype``
    product accumulated in float32), then the plain epilogue."""
    _check_stem(in2, w2, bias, out_dtype, mm_dtype)
    c = w2.shape[2]
    x = in2.to(mm_dtype).float().permute(0, 3, 1, 2)
    # (KX, KY·12 + s, o) → (o, s, KY, KX)
    w = w2.to(mm_dtype).float().reshape(4, 4, 12, c).permute(3, 2, 1, 0)
    y = F.conv2d(x, w.contiguous()).permute(0, 2, 3, 1)
    return bias_relu_pool_reference(y, bias, out_dtype)


def pack_stem_weights(w2: torch.Tensor) -> torch.Tensor:
    """The bfloat16 weight image of the wgmma kernel from ``w2`` (4, 48, 64):
    (12·64·16,), per K step of 16 (K = KY·48 + KX·12 + slot, the order in
    which a conv column's 48 values of one KY lie in the space-to-depth row)
    the core-matrix order ``[channel // 8][K half][channel % 8][8 values]``
    that the tensor cores read B in (``fused_stem.cu``)."""
    if w2.dim() != 3 or tuple(w2.shape) != (4, 48, 64):
        raise ValueError(f"expected w2 of (4, 48, 64), got {tuple(w2.shape)}")
    # (KX, KY·12 + s, o) → wt[o][KY·48 + KX·12 + s]
    wt = w2.reshape(4, 4, 12, 64).permute(3, 1, 0, 2).reshape(64, 192)
    # [o // 8][o % 8][ks][K half][8] → [ks][o // 8][K half][o % 8][8]
    img = wt.to(torch.bfloat16).reshape(8, 8, 12, 2, 8).permute(2, 0, 3, 1, 4)
    return img.contiguous().reshape(-1)


_PACKED: dict = {}


def _packed_weights(w2: torch.Tensor) -> torch.Tensor:
    """:func:`pack_stem_weights` of ``w2``, made once per weight tensor (and
    again after an in-place change of it; an inference-mode tensor keeps no
    version counter, so one changed in place is not packed again)."""
    version = None if w2.is_inference() else w2._version
    key = (w2.data_ptr(), w2.device, w2.dtype, version)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w2:
        return hit[1]
    if len(_PACKED) >= 8:
        _PACKED.clear()
    packed = pack_stem_weights(w2)
    _PACKED[key] = (weakref.ref(w2), packed)
    return packed


def stem_wgmma_plan(b: int, hin: int, win: int, bias_map: bool,
                    bias_bf16: bool, sms: int) -> tuple[int, int, int, int]:
    """Launch plan of the wgmma kernel for ``b`` space-to-depth planes of
    ``hin × win`` cells: ``(pool_rows, blocks, tiles, smem)``.

    A block keeps the weight image, a ring of :data:`RING_SLOTS` input rows
    and the bias map's rows of one band of ``pool_rows`` pooled rows (2 ·
    pool_rows + 1 conv rows) in ``smem`` bytes of shared memory, so the band
    is as tall as :data:`SMEM_BUDGET` allows (the whole plane for a (64,)
    bias). ``blocks`` persistent blocks (at most one an SM) share the
    (band, image) items; ``tiles`` consumer warpgroups of 4 ·
    :data:`POOLS_PER_WARP` pooled columns each cover a row.
    """
    hc, wc = hin - 3, win - 3
    ho, wo = _pooled(hc), _pooled(wc)
    tiles = -(-wo // (4 * POOLS_PER_WARP))
    slot = (win * 24 + 16 + 15) // 16 * 16
    fixed = W_IMAGE_BYTES + RING_SLOTS * slot
    if bias_map:
        row = wc * BIAS_PITCH * (2 if bias_bf16 else 4)
        pool_rows = min(((SMEM_BUDGET - fixed) // row - 1) // 2, ho)
        if pool_rows < 1:
            raise ValueError(f"a bias map {wc} columns wide does not fit "
                             f"the stem kernel's shared memory")
        band = min(2 * pool_rows + 1, hc) * row
    else:
        pool_rows, band = ho, 64 * 4
    blocks = min(sms, b * -(-ho // pool_rows))
    return pool_rows, blocks, tiles, fixed + band


def fused_stem_kernel(in2: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16,
                      mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA ``in2`` (B, Hc+3, Wc+3, 12) in
    float32 or bfloat16, Wc ≤ 128, with ``w2`` (4, 48, 64) and ``bias`` (64,)
    or (Hc, Wc, 64). ``mm_dtype`` bfloat16 runs the wgmma kernel (bfloat16
    products, float32 accumulation) from the weight image of ``w2``, packed
    once per weight tensor, and reads a bias map in its own type (bfloat16
    or float32); float32 runs the FMA kernel on float32 ``w2`` and bias.
    Raises on anything else."""
    _check_stem(in2, w2, bias, out_dtype, mm_dtype)
    if in2.device.type != "cuda":
        raise ValueError(f"the fused_stem kernel runs on CUDA tensors, not "
                         f"{in2.device}")
    b, hin, win, _ = in2.shape
    if w2.shape[2] != 64:
        raise ValueError(f"the fused_stem kernel takes 64 output channels, "
                         f"got {w2.shape[2]}")
    if win - 3 > MAX_CONV_WIDTH:
        raise ValueError(f"the fused_stem kernel takes conv planes up to "
                         f"{MAX_CONV_WIDTH} wide, got {win - 3}")
    if w2.dtype not in _DTYPES or bias.dtype not in _DTYPES:
        raise ValueError("the fused_stem kernel takes float32 or bfloat16 w2 "
                         "and bias")
    in2 = in2.to(mm_dtype)  # the product's inputs are rounded to mm_dtype
    bias_map = bias.dim() == 3
    if mm_dtype == torch.float32 or not bias_map:
        bias = bias.float()
    if not all(t.is_contiguous() for t in (in2, w2, bias)):
        raise ValueError("the fused_stem kernel needs contiguous inputs")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    out = torch.empty(b, _pooled(hin - 3), _pooled(win - 3), 64,
                      dtype=out_dtype, device=in2.device)
    lib = load_library()
    out_bf16 = int(out_dtype == torch.bfloat16)
    with torch.cuda.device(in2.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mm_dtype == torch.bfloat16:
            bias_bf16 = bias.dtype == torch.bfloat16
            sms = torch.cuda.get_device_properties(in2.device).multi_processor_count
            pool_rows, blocks, tiles, _ = stem_wgmma_plan(
                b, hin, win, bias_map, bias_bf16, sms)
            rc = lib.hipac_fused_stem_wgmma(
                in2.data_ptr(), _packed_weights(w2).data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, hin, win, pool_rows,
                blocks, tiles, int(bias_map), int(bias_bf16), out_bf16, stream)
        else:
            w32 = w2.float()
            rc = lib.hipac_fused_stem(
                in2.data_ptr(), w32.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, hin, win, POOL_ROWS,
                int(bias_map), out_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"fused_stem kernel launch failed: cudaError {rc}")
    count_launch(fused_stem_kernel)
    return out


fused_stem_kernel.launches = 0


def fused_stem(in2: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype = torch.bfloat16,
               mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the fused stem: (B, Hc+3, Wc+3, 12) → (B, ⌈Hc/2⌉, ⌈Wc/2⌉, C), the
    counterpart of the JAX ``fused_stem``.

    Args:
        in2: space-to-depth input, float32 or bfloat16
            (:func:`stem_space_to_depth`, or the folded forward's
            ``u8 − 128`` cells, which are exact in bfloat16).
        w2, bias: (4, 48, C) weights and a (C,) bias
            (:func:`fold_stem_params`) or an (Hc, Wc, C) bias map.
        mm_dtype: type the product's inputs are rounded to; it accumulates
            in float32 (bfloat16 for serving, float32 for parity tests).

    The kernel's result for CUDA tensors (C = 64, Wc ≤ 128), the plain
    version's for CPU tensors.
    """
    if in2.device.type == "cpu":
        return fused_stem_reference(in2, w2, bias, out_dtype, mm_dtype)
    return fused_stem_kernel(in2.contiguous(), w2.contiguous(),
                             bias.contiguous(), out_dtype, mm_dtype)


def stem_forward(imgs_u8: torch.Tensor, conv_kernel, bn_scale, bn_bias,
                 bn_mean, bn_var, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The fused stem from raw uint8 images: :func:`fold_stem_params`,
    :func:`stem_space_to_depth` in float32, :func:`fused_stem` with
    ``dtype`` as product and output type."""
    w2, bias = fold_stem_params(conv_kernel, bn_scale, bn_bias, bn_mean,
                                bn_var, eps)
    in2 = stem_space_to_depth(imgs_u8, torch.float32)
    dev = imgs_u8.device
    return fused_stem(in2, w2.to(dev), bias.to(dev), out_dtype=dtype,
                      mm_dtype=dtype)


def stem_forward_hybrid(imgs_u8: torch.Tensor, conv_kernel, bn_scale, bn_bias,
                        bn_mean, bn_var, eps: float = 1e-5,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The stem as normalize (the ``fused_normalize`` kernel on the card) →
    library 7×7/2 convolution with the BN scale folded into the weights →
    :func:`bias_relu_pool`: one intermediate plane in device memory instead
    of three."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    dev = imgs_u8.device
    w = torch.as_tensor(conv_kernel, dtype=torch.float32).to(dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    gamma = f32(bn_scale) * torch.rsqrt(f32(bn_var) + eps)
    bias = f32(bn_bias) - f32(bn_mean) * gamma
    w = (w * gamma).permute(3, 2, 0, 1).to(dtype)  # HWIO → OIHW
    x, _ = fused_normalize(imgs_u8, dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.contiguous(memory_format=torch.channels_last), None, 2, 3)
    return bias_relu_pool(y.permute(0, 2, 3, 1), bias, out_dtype=dtype)
