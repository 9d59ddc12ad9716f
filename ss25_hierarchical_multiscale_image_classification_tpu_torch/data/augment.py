"""Preprocessing on the device: ImageNet normalize, bilinear resize, and the
SimCLR views.

Counterparts of the JAX package's ``data/augment.py``: ``normalize``, the
``jax.image.resize(..., "bilinear")`` call of its sliding-window step, and
the fused SimCLR view path (``sample_simclr_view_params``,
``_sample_crop_box``, ``_interp_matrix``, ``_jitter_affine``,
``_apply_color_affine``, ``simclr_view_batch``, ``simclr_two_views``). The
classifier's training augmentation (``augment_batch``) comes with the
classifier trainer.

Random draws come from a ``torch.Generator`` on the device and are kept
apart from the arithmetic: :func:`sample_crop_boxes` and
:func:`sample_simclr_view_params` draw, :func:`simclr_view_batch` computes,
so a test can hand both packages the same boxes and parameters (the two
frameworks' generators give different bits from one seed).
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


# ---------------------------------------------------------------------------
# SimCLR views
# ---------------------------------------------------------------------------

_YIQ_FROM_RGB_64 = np.array(
    [[0.299, 0.587, 0.114],
     [0.596, -0.274, -0.322],
     [0.211, -0.523, 0.312]], dtype=np.float64,
)
_RGB_FROM_YIQ_64 = np.linalg.inv(_YIQ_FROM_RGB_64)
_LUMA = (0.299, 0.587, 0.114)


@functools.lru_cache(maxsize=None)
def _view_constants(device: torch.device) -> dict[str, torch.Tensor]:
    """The views' float32 color constants on ``device``, made once (see
    :func:`_affine`)."""
    consts = {"to_yiq": _YIQ_FROM_RGB_64, "from_yiq": _RGB_FROM_YIQ_64,
              "luma": _LUMA, "mean": IMAGENET_MEAN, "std": IMAGENET_STD}
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device)
            for k, v in consts.items()}


def _scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``, made by a fill, not a host copy:
    a divisor that PyTorch's CUDA division by a host scalar would turn into
    a product by its reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _uniform(generator: torch.Generator, b: int, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(b, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def sample_crop_boxes(generator: torch.Generator, b: int, H: int, W: int,
                      scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                      ) -> tuple[torch.Tensor, ...]:
    """torchvision RandomResizedCrop boxes with one rejection-free draw each
    (the JAX package's ``_sample_crop_box``, batched): area and log-aspect
    uniform, the box clamped to the image. Returns (y0, x0, h, w), each (b,)
    float32 on the generator's device."""
    area = _uniform(generator, b, scale[0], scale[1]) * H * W
    r = torch.exp(_uniform(generator, b, math.log(ratio[0]),
                           math.log(ratio[1])))
    w = torch.clamp(torch.sqrt(area * r), 1.0, W)
    h = torch.clamp(torch.sqrt(area / r), 1.0, H)
    y0 = torch.rand(b, generator=generator, device=generator.device) * (H - h)
    x0 = torch.rand(b, generator=generator, device=generator.device) * (W - w)
    return y0, x0, h, w


def sample_simclr_view_params(generator: torch.Generator, b: int) -> dict:
    """Per-example draws for one SimCLR view batch: hflip@0.5, jitter@0.8
    with ColorJitter(0.4,0.4,0.4,0.1) factors, grayscale@0.2."""
    dev = generator.device

    def bernoulli(p: float) -> torch.Tensor:
        return torch.rand(b, generator=generator, device=dev) < p

    return {
        "h": bernoulli(0.5),
        "jp": bernoulli(0.8),
        "gp": bernoulli(0.2),
        "fb": _uniform(generator, b, 0.6, 1.4),
        "fc": _uniform(generator, b, 0.6, 1.4),
        "fs": _uniform(generator, b, 0.6, 1.4),
        "fh": _uniform(generator, b, -0.1, 0.1),
    }


def _interp_matrix(p0: torch.Tensor, span: torch.Tensor, in_size: int,
                   out_size: int) -> torch.Tensor:
    """(B, out, in) bilinear interpolation matrices for the boxes
    [p0, p0+span) of an ``in_size`` axis: two nonzeros per row, in float32
    (at bf16, positions near 224 quantize to ~1.75 px)."""
    dev = p0.device
    o = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
         ) / _scalar(out_size, dev)
    s = p0.float()[:, None] + o[None, :] * span.float()[:, None] - 0.5
    lo = torch.clamp(torch.floor(s), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    w = torch.clamp(s - lo, 0.0, 1.0)[..., None]
    cols = torch.arange(in_size, dtype=torch.float32, device=dev)
    # lo == hi at clipped borders: the two weights still total 1
    return (cols == lo[..., None]).float() * (1 - w) + (
        cols == hi[..., None]).float() * w


def _jitter_affine(params: dict, m0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brightness, contrast, saturation and hue as one per-example color
    map: (B,3,3) matrix and (B,) bias, float32. ``m0`` is each image's mean
    in [0,1]; out = (fb·fc)·(R_hue @ M_sat) @ x + (1−fc)·fb·m0·1."""
    fb, fc, fs = params["fb"].float(), params["fc"].float(), params["fs"].float()
    theta = params["fh"].float() * 2.0 * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    dev = fb.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    g = torch.full((3, 3), 1.0 / 3.0, dtype=torch.float32, device=dev)
    m_sat = fs[:, None, None] * eye + (1.0 - fs)[:, None, None] * g
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, cos, -sin], -1),
        torch.stack([zero, sin, cos], -1),
    ], -2)  # (B,3,3) chroma-plane rotation in YIQ
    c = _view_constants(dev)
    r_hue = torch.einsum("ij,bjk,kl->bil", c["from_yiq"], rot, c["to_yiq"])
    m = torch.einsum("bij,bjk->bik", r_hue, m_sat) * (fb * fc)[:, None, None]
    bias = (1.0 - fc) * fb * m0.float()
    return m, bias


def _apply_color_affine(m: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B,3,3) matrix + (B,) or (B,3) bias applied per pixel of NHWC ``x``,
    channel by channel in ``dtype``."""
    md = m.to(dtype)
    b2 = bias.to(dtype)
    if b2.dim() == 1:
        b2 = b2[:, None]
    x = x.to(dtype)
    r, g, b3 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([
        md[:, d, 0, None, None] * r
        + md[:, d, 1, None, None] * g
        + md[:, d, 2, None, None] * b3
        + b2[:, d % b2.shape[1], None, None]
        for d in range(3)
    ], dim=-1)


def simclr_view_batch(boxes: tuple[torch.Tensor, ...], params: dict,
                      imgs_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """uint8 (B,H,W,3) → one normalized SimCLR view (B,out,out,3) bfloat16.

    The crop is two batched products with the boxes' bilinear interpolation
    matrices (the horizontal flip reverses the x matrix's rows), in bf16
    with float32 sums, as the JAX package computes it; then two color
    passes: the jitter affine (or identity) and a clip, then grayscale (or
    identity) folded into the ImageNet normalization. The contrast mean
    comes from the matrices alone: mean = (Σ_o wy)·img·(Σ_p wx) / out².
    """
    b, H, W = imgs_u8.shape[0], imgs_u8.shape[1], imgs_u8.shape[2]
    dev = imgs_u8.device
    bf16 = torch.bfloat16
    x8 = imgs_u8.to(bf16) / 255.0
    y0, x0, hh, ww = boxes
    wy = _interp_matrix(y0, hh, H, out_size)  # (B, out, H) float32
    wx = _interp_matrix(x0, ww, W, out_size)  # (B, out, W) float32
    wx = torch.where(params["h"][:, None, None], wx.flip(1), wx)

    u = wy.sum(dim=1)  # (B, H)
    v = wx.sum(dim=1)  # (B, W)
    m0 = torch.einsum("bh,bhwc,bw->bc", u, x8.float(), v).mean(dim=1) / (
        out_size * out_size)

    tmp = torch.bmm(wy.to(bf16), x8.reshape(b, H, W * 3))  # (B, out, W·3)
    tmp = tmp.reshape(b, out_size, W, 3)
    x = torch.einsum("bpw,bowc->bopc", wx.to(bf16), tmp)

    mj, bj = _jitter_affine(params, m0)
    jp = params["jp"]
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(b, 3, 3)
    m1 = torch.where(jp[:, None, None], mj, eye)
    b1 = torch.where(jp, bj, 0.0)
    x = torch.clamp(_apply_color_affine(m1, b1, x), 0.0, 1.0)

    c = _view_constants(dev)
    gmat = c["luma"][None, None, :].expand(b, 3, 3)
    m2 = torch.where(params["gp"][:, None, None], gmat, eye)
    mean, std = c["mean"], c["std"]
    m2 = m2 / std[None, :, None]
    e = (-mean / std)[None, :].expand(b, 3)
    return _apply_color_affine(m2, e, x, dtype=torch.float32).to(bf16)


def simclr_two_views(generator: torch.Generator, imgs_u8: torch.Tensor,
                     out_size: int = 224) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B,H,W,3) → two independently augmented normalized views
    (bfloat16 (B,out,out,3) each) of every example, drawn from
    ``generator`` (on the images' device)."""
    b, H, W = imgs_u8.shape[0], imgs_u8.shape[1], imgs_u8.shape[2]
    views = []
    for _ in range(2):
        boxes = sample_crop_boxes(generator, b, H, W)
        params = sample_simclr_view_params(generator, b)
        views.append(simclr_view_batch(boxes, params, imgs_u8, out_size))
    return views[0], views[1]
