"""Plain float32 copies of the inputs' arithmetic: ImageNet normalize, the
classifier's training augmentation, the SimCLR views, and the random draws
that both take from a ``torch.Generator``.

The draws are made in the order, and by the same ``torch.rand`` /
``torch.randint`` calls, that the program under test makes them, so that a
generator seeded alike on the same device gives both sides the same flips,
rotations, boxes and colour factors. Everything after the draws is float32
here (the program rounds its colour arithmetic and crops to bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_TO_YIQ = np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.322],
                    [0.211, -0.523, 0.312]], np.float64)
_FROM_YIQ = np.linalg.inv(_TO_YIQ)
_LUMA = (0.299, 0.587, 0.114)


def _const(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float64), dtype=torch.float32,
                           device=device)


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) → ``(x − 255·mean_c) / (255·std_c)`` in float32."""
    mean = _const([m * 255.0 for m in IMAGENET_MEAN], u8.device)
    std = _const([s * 255.0 for s in IMAGENET_STD], u8.device)
    return (u8.to(torch.float32) - mean) / std


def cell_means(u8: torch.Tensor) -> torch.Tensor:
    """Each image's mean over all its uint8 values: the exact integer sum,
    rounded to float32, divided in float32."""
    b = u8.shape[0]
    sums = u8.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    n = torch.full((), float(u8[0].numel()), dtype=torch.float32,
                   device=u8.device)
    return sums.to(torch.float32) / n


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _uniform(g: torch.Generator, b: int, lo: float, hi: float):
    return torch.rand(b, generator=g, device=g.device) * (hi - lo) + lo


def draw_augment(g: torch.Generator, b: int) -> dict:
    """The classifier augmentation's draws for ``b`` images: hflip, vflip,
    k·90°, brightness, contrast, saturation (±0.2) and hue (±0.1 turn)."""
    return {
        "h": torch.rand(b, generator=g, device=g.device) < 0.5,
        "v": torch.rand(b, generator=g, device=g.device) < 0.5,
        "k": torch.randint(0, 4, (b,), generator=g, device=g.device),
        "fb": _uniform(g, b, 0.8, 1.2),
        "fc": _uniform(g, b, 0.8, 1.2),
        "fs": _uniform(g, b, 0.8, 1.2),
        "fh": _uniform(g, b, -0.1, 0.1),
    }


def draw_view(g: torch.Generator, b: int, size: int) -> dict:
    """One SimCLR view's draws for ``b`` images of ``size``²: a
    RandomResizedCrop box (area 0.08–1, aspect 3/4–4/3, one draw each,
    clamped), then hflip, jitter (p 0.8), grayscale (p 0.2) and the jitter
    factors (±0.4, hue ±0.1 turn)."""
    dev = g.device
    area = _uniform(g, b, 0.08, 1.0) * size * size
    r = torch.exp(_uniform(g, b, math.log(3 / 4), math.log(4 / 3)))
    w = torch.clamp(torch.sqrt(area * r), 1.0, size)
    h = torch.clamp(torch.sqrt(area / r), 1.0, size)
    y0 = torch.rand(b, generator=g, device=dev) * (size - h)
    x0 = torch.rand(b, generator=g, device=dev) * (size - w)
    out = {"y0": y0, "x0": x0, "hh": h, "ww": w}
    out["flip"] = torch.rand(b, generator=g, device=dev) < 0.5
    out["jp"] = torch.rand(b, generator=g, device=dev) < 0.8
    out["gp"] = torch.rand(b, generator=g, device=dev) < 0.2
    out["fb"] = _uniform(g, b, 0.6, 1.4)
    out["fc"] = _uniform(g, b, 0.6, 1.4)
    out["fs"] = _uniform(g, b, 0.6, 1.4)
    out["fh"] = _uniform(g, b, -0.1, 0.1)
    return out


# ---------------------------------------------------------------------------
# Colour
# ---------------------------------------------------------------------------


def jitter_matrix(d: dict) -> torch.Tensor:
    """(B, 3, 3): brightness·contrast times the hue rotation in YIQ times
    the saturation blend toward the channel mean."""
    fb, fc, fs = d["fb"].float(), d["fc"].float(), d["fs"].float()
    theta = d["fh"].float() * (2.0 * math.pi)
    dev = fb.device
    b = fb.shape[0]
    rot = torch.zeros(b, 3, 3, dtype=torch.float32, device=dev)
    rot[:, 0, 0] = 1.0
    rot[:, 1, 1] = torch.cos(theta)
    rot[:, 1, 2] = -torch.sin(theta)
    rot[:, 2, 1] = torch.sin(theta)
    rot[:, 2, 2] = torch.cos(theta)
    hue = _const(_FROM_YIQ, dev) @ rot @ _const(_TO_YIQ, dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    sat = fs[:, None, None] * eye + (1.0 - fs)[:, None, None] / 3.0
    return (hue @ sat) * (fb * fc)[:, None, None]


def _apply(m: torch.Tensor, bias: torch.Tensor, x: torch.Tensor):
    """Per-image (B,3,3) colour map and (B,) bias on NHWC float32 pixels."""
    return torch.einsum("bij,bhwj->bhwi", m, x) + bias[:, None, None, None]


def _normalize01(x: torch.Tensor) -> torch.Tensor:
    mean = _const(IMAGENET_MEAN, x.device)
    std = _const(IMAGENET_STD, x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Classifier training augmentation
# ---------------------------------------------------------------------------


def augment(d: dict, u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) → normalized float32: hflip, then vflip, then k
    counter-clockwise quarter turns; the jitter's colour map with the
    contrast offset on each image's mean; clip to [0, 1]; normalize."""
    x = u8.to(torch.float32) / 255.0
    x = torch.where(d["h"][:, None, None, None], x.flip(2), x)
    x = torch.where(d["v"][:, None, None, None], x.flip(1), x)
    out = x.clone()
    for k in range(1, 4):
        sel = d["k"] == k
        if bool(sel.any()):
            out[sel] = torch.rot90(x[sel], k, dims=(1, 2))
    m0 = cell_means(u8) / 255.0
    bias = (1.0 - d["fc"].float()) * d["fb"].float() * m0
    y = torch.clamp(_apply(jitter_matrix(d), bias, out), 0.0, 1.0)
    return _normalize01(y)


# ---------------------------------------------------------------------------
# SimCLR views
# ---------------------------------------------------------------------------


def interp_matrix(p0: torch.Tensor, span: torch.Tensor, n_in: int,
                  n_out: int) -> torch.Tensor:
    """(B, n_out, n_in) bilinear sampling of the boxes [p0, p0 + span),
    half-pixel centres, clamped at the edges (two weights a row)."""
    dev = p0.device
    o = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) / n_out
    s = p0.float()[:, None] + o[None, :] * span.float()[:, None] - 0.5
    lo = torch.clamp(torch.floor(s), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    w = torch.clamp(s - lo, 0.0, 1.0)
    m = torch.zeros(p0.shape[0], n_out, n_in, dtype=torch.float32, device=dev)
    m.scatter_add_(2, lo.long()[..., None], (1.0 - w)[..., None])
    m.scatter_add_(2, hi.long()[..., None], w[..., None])
    return m


def view(d: dict, u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """uint8 (B, S, S, 3) → one normalized float32 SimCLR view: the box
    resampled bilinearly (mirrored where ``flip``), the jitter where
    ``jp`` with the contrast offset on the crop's mean, clip, grayscale by
    luma where ``gp``, normalize."""
    b, size = u8.shape[0], u8.shape[1]
    x = u8.to(torch.float32) / 255.0
    wy = interp_matrix(d["y0"], d["hh"], size, out_size)
    wx = interp_matrix(d["x0"], d["ww"], size, out_size)
    wx = torch.where(d["flip"][:, None, None], wx.flip(1), wx)
    crop = torch.einsum("boh,bhwc,bpw->bopc", wy, x, wx)
    m0 = crop.mean(dim=(1, 2, 3))
    eye = torch.eye(3, dtype=torch.float32, device=u8.device).expand(b, 3, 3)
    m1 = torch.where(d["jp"][:, None, None], jitter_matrix(d), eye)
    b1 = torch.where(d["jp"], (1.0 - d["fc"].float()) * d["fb"].float() * m0,
                     0.0)
    y = torch.clamp(_apply(m1, b1, crop), 0.0, 1.0)
    luma = _const(_LUMA, u8.device)[None, None, :].expand(b, 3, 3)
    m2 = torch.where(d["gp"][:, None, None], luma, eye)
    y = _apply(m2, torch.zeros(b, device=u8.device), y)
    return _normalize01(y)
