"""Preprocessing on the device: ImageNet normalize, bilinear resize, the
SimCLR views and the classifier's training augmentation.

Counterparts of the JAX package's ``data/augment.py``: ``normalize``, the
``jax.image.resize(..., "bilinear")`` call of its sliding-window step,
``color_jitter`` and ``random_resized_crop`` (their math in
:func:`adjust_color` and :func:`resample_box`), the
fused SimCLR view path (``sample_simclr_view_params``,
``_sample_crop_box``, ``_interp_matrix``, ``_jitter_affine``,
``_apply_color_affine``, ``simclr_view_batch``, ``simclr_two_views``), and
the training augmentation (``_d4_tables``, ``sample_augment_params``,
``augment_batch``, its per-example oracle ``_augment_one_with_params``,
``preprocess_batch``, ``preprocess_multiscale_batch``). :func:`augment_batch`
is the plain version of the hand-written kernel of ``ops/augment.py``,
which the trainers run on the card.

Random draws come from a ``torch.Generator`` on the device and are kept
apart from the arithmetic: :func:`sample_jitter_factors`,
:func:`sample_crop_boxes`,
:func:`sample_simclr_view_params` and :func:`sample_augment_params` draw,
:func:`simclr_view_batch` and :func:`augment_batch` compute, so a test can
hand both packages the same boxes and parameters (the two frameworks'
generators give different bits from one seed).
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


def take_rows(draws, rows: tuple[int, int] | None, b: int):
    """``draws`` (a dict or tuple of per-example tensors of a global batch)
    cut to rows [start, start + b) for ``rows = (start, total)``; as they
    are without ``rows``."""
    if rows is None:
        return draws
    start = rows[0]
    if isinstance(draws, dict):
        return {k: v[start:start + b] for k, v in draws.items()}
    return tuple(v[start:start + b] for v in draws)


def _draw_size(rows: tuple[int, int] | None, b: int) -> int:
    if rows is None:
        return b
    start, total = rows
    if not 0 <= start <= total - b:
        raise ValueError(f"rows [{start}, {start + b}) outside a global "
                         f"batch of {total}")
    return total


def simclr_two_views(generator: torch.Generator, imgs_u8: torch.Tensor,
                     out_size: int = 224, rows: tuple[int, int] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B,H,W,3) → two independently augmented normalized views
    (bfloat16 (B,out,out,3) each) of every example, drawn from
    ``generator`` (on the images' device).

    ``rows = (start, total)``: the batch is rows [start, start + B) of a
    global batch of ``total`` (this rank's share under data parallelism);
    the draws are made for the whole global batch and these rows taken, so
    that every world size augments each example alike."""
    b, H, W = imgs_u8.shape[0], imgs_u8.shape[1], imgs_u8.shape[2]
    n = _draw_size(rows, b)
    views = []
    for _ in range(2):
        boxes = take_rows(sample_crop_boxes(generator, n, H, W), rows, b)
        params = take_rows(sample_simclr_view_params(generator, n), rows, b)
        views.append(simclr_view_batch(boxes, params, imgs_u8, out_size))
    return views[0], views[1]


# ---------------------------------------------------------------------------
# Classifier training augmentation
#
# Flips and k·90° rotations generate the dihedral group D4, every element of
# which is (transpose?) ∘ (x-reverse?) ∘ (y-reverse?): one index map per
# image. Brightness, contrast, saturation and hue are jointly one affine
# colour map per image (``_jitter_affine``), whose contrast offset needs the
# image's mean. So the batch is: a per-image mean, then one pass of index
# map, affine, clip and normalize.
# ---------------------------------------------------------------------------


def _d4_tables():
    """Brute-force the (hflip, vflip, rot_k) → (transpose, xrev, yrev)
    composition table with numpy at import time."""
    probe = np.arange(16.0).reshape(4, 4)

    def old(h, v, k):
        x = probe[:, ::-1] if h else probe
        x = x[::-1] if v else x
        return np.rot90(x, k)

    def rep(t, fx, fy):
        x = probe.T if t else probe
        x = x[:, ::-1] if fx else x
        return x[::-1] if fy else x

    t_tab = np.zeros((2, 2, 4), np.int32)
    fx_tab = np.zeros((2, 2, 4), np.int32)
    fy_tab = np.zeros((2, 2, 4), np.int32)
    for h in range(2):
        for v in range(2):
            for k in range(4):
                want = old(h, v, k)
                matches = [
                    (t, fx, fy)
                    for t in range(2)
                    for fx in range(2)
                    for fy in range(2)
                    if np.array_equal(rep(t, fx, fy), want)
                ]
                if not matches:
                    raise AssertionError("D4 decomposition failed")
                t_tab[h, v, k], fx_tab[h, v, k], fy_tab[h, v, k] = matches[0]
    return t_tab, fx_tab, fy_tab


_D4_T, _D4_FX, _D4_FY = _d4_tables()


@functools.lru_cache(maxsize=None)
def _d4_device_tables(device: torch.device) -> torch.Tensor:
    """(3, 2, 2, 4) int64: the three D4 tables on ``device``, made once."""
    return torch.as_tensor(np.stack([_D4_T, _D4_FX, _D4_FY]),
                           dtype=torch.int64).to(device)


def d4_flags(params: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(transpose, x-reverse, y-reverse) as (B,) bool tensors for the draws
    ``h``, ``v``, ``k`` of ``params``."""
    h, v, k = params["h"].long(), params["v"].long(), params["k"].long()
    tab = _d4_device_tables(k.device)
    return tab[0][h, v, k] != 0, tab[1][h, v, k] != 0, tab[2][h, v, k] != 0


def sample_augment_params(generator: torch.Generator, b: int,
                          brightness: float = 0.2, contrast: float = 0.2,
                          saturation: float = 0.2, hue: float = 0.1) -> dict:
    """Per-example augmentation draws for a batch of ``b`` images: hflip and
    vflip at 0.5, k uniform in 0..3, and the ColorJitter factors uniform in
    [max(0, 1−s), 1+s] (hue in [−hue, hue]), on the generator's device."""
    dev = generator.device

    def bernoulli() -> torch.Tensor:
        return torch.rand(b, generator=generator, device=dev) < 0.5

    return {
        "h": bernoulli(),
        "v": bernoulli(),
        "k": torch.randint(0, 4, (b,), generator=generator, device=dev),
        "fb": _uniform(generator, b, max(0.0, 1 - brightness), 1 + brightness),
        "fc": _uniform(generator, b, max(0.0, 1 - contrast), 1 + contrast),
        "fs": _uniform(generator, b, max(0.0, 1 - saturation), 1 + saturation),
        "fh": _uniform(generator, b, -hue, hue),
    }


def augment_means(sums: torch.Tensor, n: int) -> torch.Tensor:
    """Exact per-image integer sums of the uint8 pixels → each image's mean
    in [0, 1], float32: the sum rounded to float32, then two IEEE divisions
    (by ``n`` and by 255, device tensors as in ``normalize``)."""
    dev = sums.device
    return sums.to(torch.float32) / _scalar(float(n), dev) / _scalar(255.0, dev)


def augment_matrix(params: dict, dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """The per-image colour matrix of ``params``, (B, 3, 3) rounded to
    ``dtype``, contiguous: :func:`_jitter_affine`'s, which depends on the
    draws only."""
    fb = params["fb"]
    m, _ = _jitter_affine(params, torch.zeros(fb.shape, device=fb.device))
    return m.to(dtype).contiguous()


def augment_bias(params: dict, m0: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The per-image contrast bias of ``params`` for images of mean ``m0``:
    :func:`_jitter_affine`'s ``((1 − fc)·fb)·m0`` in float32, rounded to
    ``dtype``, contiguous."""
    fb, fc = params["fb"].float(), params["fc"].float()
    return ((1.0 - fc) * fb * m0.float()).to(dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _inv255(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((), 1.0 / 255.0, dtype=dtype, device=device)


def augment_batch(params: dict, imgs_u8: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Batched training augmentation: uint8 (B, S, S, 3) → ImageNet-
    normalized float32 (B, S, S, 3), each image through its D4 element and
    colour affine. The plain version of ``ops/augment.py``'s kernel.

    In the JAX function's order and roundings: the D4 map; the per-image
    mean (here an exact integer sum, see :func:`augment_means`); the affine
    (:func:`augment_matrix`, :func:`augment_bias`) rounded to ``dtype``;
    each channel ``x·(1/255)`` in ``dtype``; each output channel
    ``((m_d0·r + m_d1·g) + m_d2·b) + bias`` with every product and sum
    rounded to ``dtype``; clip to [0, 1]; in float32
    ``(c·255 − 255·mean_d) / (255·std_d)`` with IEEE divisions.
    """
    b, hh, ww = imgs_u8.shape[0], imgs_u8.shape[1], imgs_u8.shape[2]
    if hh != ww:
        raise ValueError(f"D4 augmentation needs square images, got {hh}×{ww}")
    t, fx, fy = d4_flags(params)
    x = imgs_u8
    x = torch.where(t[:, None, None, None], x.transpose(1, 2), x)
    x = torch.where(fx[:, None, None, None], x.flip(2), x)
    x = torch.where(fy[:, None, None, None], x.flip(1), x)

    sums = imgs_u8.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    m0 = augment_means(sums, imgs_u8[0].numel())
    md, biasd = augment_matrix(params, dtype), augment_bias(params, m0, dtype)
    xd = x.to(dtype) * _inv255(dtype, x.device)
    r, g, b3 = xd[..., 0], xd[..., 1], xd[..., 2]
    mean, std = _affine(x.device)

    def chan(d):
        c = (md[:, d, 0, None, None] * r + md[:, d, 1, None, None] * g
             + md[:, d, 2, None, None] * b3 + biasd[:, None, None])
        c = torch.clamp(c, 0.0, 1.0).to(torch.float32)
        return (c * 255.0 - mean[d]) / std[d]

    return torch.stack([chan(0), chan(1), chan(2)], dim=-1)


def _adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    # the mean reduced in float32
    mean = img.float().mean(dim=(-3, -2, -1), keepdim=True).to(img.dtype)
    return (img - mean) * factor + mean


def _adjust_saturation(img: torch.Tensor, factor: torch.Tensor
                       ) -> torch.Tensor:
    gray = img.mean(dim=-1, keepdim=True)
    return (img - gray) * factor + gray


def _apply_3x3(img: torch.Tensor, m) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return torch.stack([m[i][0] * r + m[i][1] * g + m[i][2] * b
                        for i in range(3)], dim=-1)


def _adjust_hue(img: torch.Tensor, delta_turns: torch.Tensor) -> torch.Tensor:
    """Hue rotation by ``delta_turns`` through a chroma-plane rotation in
    YIQ space."""
    theta = delta_turns.float() * 2.0 * math.pi
    cos, sin = torch.cos(theta).to(img.dtype), torch.sin(theta).to(img.dtype)
    yiq = _apply_3x3(img, _YIQ_FROM_RGB_64.tolist())
    y = yiq[..., 0]
    i = yiq[..., 1] * cos - yiq[..., 2] * sin
    q = yiq[..., 1] * sin + yiq[..., 2] * cos
    return _apply_3x3(torch.stack([y, i, q], dim=-1), _RGB_FROM_YIQ_64.tolist())


def _augment_one_with_params(img_u8: torch.Tensor, h, v, k, fb, fc, fs, fh
                             ) -> torch.Tensor:
    """The per-example op chain (flips → rot90 → brightness, contrast,
    saturation, hue → clip) in bfloat16, driven by one image's draws: the
    oracle that :func:`augment_batch` is held to. Returns (S, S, 3) in
    [0, 1], before normalization."""
    img = img_u8.to(torch.bfloat16) / 255.0
    if bool(h):
        img = img.flip(1)
    if bool(v):
        img = img.flip(0)
    img = torch.rot90(img, int(k), dims=(0, 1))
    img = img * torch.as_tensor(fb).to(img.dtype)
    img = _adjust_contrast(img, torch.as_tensor(fc).to(img.dtype))
    img = _adjust_saturation(img, torch.as_tensor(fs).to(img.dtype))
    img = _adjust_hue(img, torch.as_tensor(fh))
    return torch.clamp(img, 0.0, 1.0)


def sample_jitter_factors(generator: torch.Generator, brightness: float,
                          contrast: float, saturation: float, hue: float
                          ) -> tuple[torch.Tensor, ...]:
    """torchvision ColorJitter's draws: brightness, contrast and saturation
    factors uniform in [max(0, 1 − s), 1 + s], the hue shift in [−h, h]
    turns; four float32 scalars on the generator's device."""
    return tuple(
        _uniform(generator, 1, lo, hi)[0]
        for lo, hi in ((max(0.0, 1 - brightness), 1 + brightness),
                       (max(0.0, 1 - contrast), 1 + contrast),
                       (max(0.0, 1 - saturation), 1 + saturation),
                       (-hue, hue)))


def adjust_color(img: torch.Tensor, fb, fc, fs, fh) -> torch.Tensor:
    """Brightness, contrast, saturation and hue by the factors ``fb``,
    ``fc``, ``fs`` and the shift ``fh`` (turns), in that order, then a
    clip to [0, 1]: float (..., H, W, 3) in [0, 1], computed in its dtype
    (the contrast mean in float32, over the last three axes)."""
    def cast(f):
        return torch.as_tensor(f, device=img.device).to(img.dtype)

    img = img * cast(fb)
    img = _adjust_contrast(img, cast(fc))
    img = _adjust_saturation(img, cast(fs))
    img = _adjust_hue(img, torch.as_tensor(fh, device=img.device))
    return torch.clamp(img, 0.0, 1.0)


def color_jitter(img: torch.Tensor, brightness: float, contrast: float,
                 saturation: float, hue: float, *,
                 generator: torch.Generator) -> torch.Tensor:
    """torchvision-style ColorJitter of a float (..., H, W, 3) image in
    [0, 1]: one draw of :func:`sample_jitter_factors` from ``generator``,
    applied by :func:`adjust_color`."""
    return adjust_color(img, *sample_jitter_factors(
        generator, brightness, contrast, saturation, hue))


def resample_box(img: torch.Tensor, y0, x0, h, w, out_size: int
                 ) -> torch.Tensor:
    """The box [y0, y0 + h) × [x0, x0 + w) of a float (H, W, 3) image,
    bilinearly resampled to (out_size, out_size, 3): two products with the
    box's interpolation matrices, summed in float32, returned in the
    image's dtype."""
    H, W = img.shape[0], img.shape[1]

    def box(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=img.device).reshape(1)

    wy = _interp_matrix(box(y0), box(h), H, out_size)[0].to(img.dtype)
    wx = _interp_matrix(box(x0), box(w), W, out_size)[0].to(img.dtype)
    tmp = torch.einsum("oh,hwc->owc", wy.float(), img.float()).to(img.dtype)
    out = torch.einsum("pw,owc->opc", wx.float(), tmp.float())
    return out.to(img.dtype)


def random_resized_crop(img: torch.Tensor, out_size: int,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), *,
                        generator: torch.Generator) -> torch.Tensor:
    """torchvision RandomResizedCrop of a float (H, W, 3) image: one box of
    :func:`sample_crop_boxes` from ``generator``, resampled by
    :func:`resample_box`."""
    y0, x0, h, w = sample_crop_boxes(generator, 1, img.shape[0], img.shape[1],
                                     scale, ratio)
    return resample_box(img, y0[0], x0[0], h[0], w[0], out_size)


def preprocess_batch(generator: torch.Generator | None, imgs_u8: torch.Tensor,
                     training: bool = True,
                     rows: tuple[int, int] | None = None) -> torch.Tensor:
    """uint8 (B, S, S, 3) → normalized float32 (B, S, S, 3). Training: one
    draw of :func:`sample_augment_params` from ``generator`` and the
    augmentation (on a card through the kernel of ``ops/augment.py``);
    evaluation: ``normalize`` only. ``rows = (start, total)``: the batch is
    rows [start, start + B) of a global batch of ``total``, and the draw is
    the global batch's (see :func:`simclr_two_views`); the kernel runs on
    these rows only."""
    if not training:
        return normalize(imgs_u8)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )

    b = imgs_u8.shape[0]
    params = take_rows(sample_augment_params(generator, _draw_size(rows, b)),
                       rows, b)
    return augment_batch_kernel(params, imgs_u8)


def preprocess_multiscale_batch(generator: torch.Generator | None,
                                imgs_by_level: dict,
                                training: bool = True,
                                rows: tuple[int, int] | None = None) -> dict:
    """``{level: uint8 (B, S, S, 3)}`` → ``{level: normalized float32}``,
    levels in sorted order. Training: ONE draw of
    :func:`sample_augment_params` for the batch, applied to every level (on
    a card the kernel of ``ops/augment.py``, once per level), so that the
    co-located patches of a cell keep one flip, rotation and colour jitter:
    they cover the same level-0 field of view. Evaluation: ``normalize``
    per level. ``rows = (start, total)``: the batch is rows
    [start, start + B) of a global batch of ``total``, the draw is the
    global batch's (see :func:`preprocess_batch`)."""
    levels = sorted(imgs_by_level)
    if not training:
        return {lvl: normalize(imgs_by_level[lvl]) for lvl in levels}
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )

    b = imgs_by_level[levels[0]].shape[0]
    params = take_rows(sample_augment_params(generator, _draw_size(rows, b)),
                       rows, b)
    return {lvl: augment_batch_kernel(params, imgs_by_level[lvl])
            for lvl in levels}
