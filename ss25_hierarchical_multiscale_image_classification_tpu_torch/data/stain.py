"""H&E stain normalization (Macenko) as batched torch ops.

Counterpart of the JAX package's ``data/stain.py``: optical densities,
the tissue mask (every channel's OD above 0.15), the OD covariance's two
leading eigenvectors, the robust angle extremes (1st and 99th percentile of
the tissue's angles in that plane), the stain basis ordered hematoxylin
first, least-squares concentrations through the pseudo-inverse, and the
remap onto a reference basis and reference 99th-percentile concentrations.
Images with almost no tissue (< ``min_tissue_frac``) pass through as they
are. Every image of a batch is computed on its own: the JAX package vmaps
one image's program and pads a batch to a power of two, which this module
need not do.

The method is ill-conditioned on tissue of one stain: the covariance's two
smaller eigenvalues then lie close together, so a rounding of the
covariance turns the plane, and angles that wrap at ±π move the
percentiles. Computed with other float32 summation orders, the same patch
can normalize to other colours (``tests/test_torch_port_stain.py`` shows
this for the JAX function itself, under a permutation of the pixels). So
this module fixes every order, and the card computes what the CPU computes:

- the optical density is a 256-entry table made on the host and indexed;
- sums over pixels are pairwise trees of elementwise adds (:func:`_tree_sum`),
  3-term products are written out as elementwise multiply-adds, and
  ``atan2`` and ``exp`` run in float64 and round to float32;
- the 3×3 eigendecompositions and the 3×2 pseudo-inverses run on the host
  (``torch.linalg`` on the CPU, float32): an eigenvector is defined only up
  to its sign, the algorithm is not sign-invariant (the percentile indices
  for q = 1 and q = 99 are no mirror images), and the card's solver need
  not pick LAPACK's signs;
- an image without a tissue pixel gets placeholder angles before the
  factorizations (JAX computes NaN stains there and discards them); its
  stains are NaN and its maximum concentrations +inf, as in JAX;
- divisions are tensor divisions (IEEE quotients on the card too) and the
  pseudo-inverse takes JAX's cut-off, 10·max(3, 2)·eps.
"""

from __future__ import annotations

import numpy as np
import torch

#: widely used reference H&E stain basis (columns: hematoxylin, eosin)
DEFAULT_STAIN_REF = np.array(
    [[0.5626, 0.2159],
     [0.7201, 0.8012],
     [0.4062, 0.5581]], np.float32,
)
#: reference 99th-percentile stain concentrations
DEFAULT_MAX_CONC = np.array([1.9705, 1.0308], np.float32)

_IO = 240.0  # transmitted-light intensity
_BETA = 0.15  # OD threshold below which pixels count as background
_ALPHA = 1.0  # robust percentile for angle extremes
_PINV_RTOL = 10 * 3 * float(np.finfo(np.float32).eps)


def _f32(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor,
                       q: float) -> torch.Tensor:
    """Per row of (B, N) ``values``, the percentile ``q`` of the entries
    where ``mask``: masked-out entries sort as +inf and the index,
    ``int(float32(q/100) · max(live − 1, 0))``, scales by the live count."""
    n = values.shape[-1]
    live = mask.sum(dim=-1)
    sorted_vals = torch.sort(
        torch.where(mask, values, torch.inf), dim=-1).values
    pos = _f32(q / 100.0, values.device) * (live - 1).clamp(min=0).float()
    idx = pos.clamp(0, n - 1).long()
    return sorted_vals.gather(-1, idx[:, None])[:, 0]


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree of elementwise adds (zero
    padded to a power of two): one order on every device and batch."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _dot3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (B, 3, N) weighted by ``w`` (B, K, 3) → (B, K, N), each entry
    ``(a0·w0 + a1·w1) + a2·w2`` in elementwise float32 operations."""
    return ((a[:, None, 0] * w[..., 0, None] + a[:, None, 1] * w[..., 1, None])
            + a[:, None, 2] * w[..., 2, None])


def _od_table(device: torch.device) -> torch.Tensor:
    """The optical density ``-log(max((v + 1) / 240, 1e-6))`` of each byte
    value v, in float32, made on the host."""
    v = torch.arange(256, dtype=torch.float32)
    io = torch.tensor(_IO, dtype=torch.float32)
    return (-torch.log(torch.clamp((v + 1.0) / io, min=1e-6))).to(device)


def _optical_density(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 3, H·W) float32 optical densities."""
    b = imgs_u8.shape[0]
    x = imgs_u8.reshape(b, -1, 3).transpose(1, 2).long()
    return _od_table(imgs_u8.device)[x]


def _stains_from_od(od: torch.Tensor):
    """Per image of (B, 3, N) optical densities: (stains (B, 3, 2), max_conc
    (B, 2), tissue_frac (B,), conc (B, 2, N), live (B,)), the placeholder
    angles standing in where an image has no tissue pixel."""
    dev = od.device
    n = od.shape[-1]
    tissue = (od > _BETA).all(dim=1)  # (B, N)
    live = tissue.sum(dim=-1)
    tissue_frac = live.float() / _f32(n, dev)

    w = tissue.float()[:, None]  # (B, 1, N)
    count = torch.clamp(live.float(), min=1.0)[:, None]  # (B, 1)
    mean = _tree_sum(od * w) / count  # (B, 3)
    centered = (od - mean[..., None]) * w
    i, j = torch.triu_indices(3, 3)
    upper = _tree_sum(centered[:, i] * centered[:, j]) / count  # (B, 6)
    cov = torch.empty((od.shape[0], 3, 3), dtype=torch.float32, device=dev)
    cov[:, i, j] = upper
    cov[:, j, i] = upper
    _vals, vecs = torch.linalg.eigh(cov.cpu())  # host: LAPACK's signs
    plane = vecs[..., 1:3]  # (B, 3, 2), the two largest eigenvectors

    proj = _dot3(od, plane.transpose(1, 2).to(dev))  # (B, 2, N)
    phi = torch.atan2(proj[:, 1].double(), proj[:, 0].double()).float()
    phis = torch.stack([_masked_percentile(phi, tissue, _ALPHA),
                        _masked_percentile(phi, tissue, 100.0 - _ALPHA)],
                       dim=1).cpu()  # (B, 2): min, max
    phis = torch.where((live > 0).cpu()[:, None], phis, 0.0)
    v = plane @ torch.stack([torch.cos(phis), torch.sin(phis)], dim=1)
    v1, v2 = v[..., 0], v[..., 1]  # (B, 3)
    # hematoxylin is the more "blue" extreme: order by first OD component
    swap = (v1[:, 0] < v2[:, 0])[:, None]
    stains = torch.stack([torch.where(swap, v2, v1),
                          torch.where(swap, v1, v2)], dim=2)  # (B, 3, 2)
    stains = stains / torch.clamp(
        torch.linalg.vector_norm(stains, dim=1, keepdim=True), min=1e-6)
    pinv = torch.linalg.pinv(stains, rtol=_PINV_RTOL).to(dev)  # (B, 2, 3)

    conc = _dot3(od, pinv)  # (B, 2, N)
    max_c = torch.stack([_masked_percentile(conc[:, 0], tissue, 99.0),
                         _masked_percentile(conc[:, 1], tissue, 99.0)],
                        dim=1)
    max_c = torch.clamp(max_c, min=1e-6)
    return stains.to(dev), max_c, tissue_frac, conc, live


def macenko_stains_batch(imgs_u8: torch.Tensor):
    """(stains (B, 3, 2), max_conc (B, 2), tissue_frac (B,)) of a (B, H, W,
    3) uint8 batch, on its device. An image without tissue has NaN stains
    and +inf maximum concentrations."""
    stains, max_c, tissue_frac, _conc, live = _stains_from_od(
        _optical_density(imgs_u8))
    stains = torch.where((live > 0)[:, None, None], stains, torch.nan)
    return stains, max_c, tissue_frac


def macenko_stains(img_u8: torch.Tensor):
    """Estimate the image's 3x2 stain basis and 99th-percentile
    concentrations (the per-image half of Macenko normalization).

    Args:
        img_u8: (H, W, 3) uint8 RGB.
    Returns:
        (stains (3, 2), max_conc (2,), tissue_frac scalar).
    """
    stains, max_c, tissue_frac = macenko_stains_batch(img_u8[None])
    return stains[0], max_c[0], tissue_frac[0]


def macenko_normalize_batch(imgs_u8: torch.Tensor, stain_ref=None,
                            max_conc_ref=None,
                            min_tissue_frac: float = 0.05) -> torch.Tensor:
    """Map a (B, H, W, 3) uint8 batch of H&E images onto the reference stain
    basis, on the batch's device; images with tissue fraction below
    ``min_tissue_frac`` pass through unchanged. The normalized float is
    clipped to [0, 255] and truncated, as ``astype(uint8)`` does."""
    if imgs_u8.shape[0] == 0:
        return imgs_u8.clone()
    dev = imgs_u8.device
    ref = _f32(DEFAULT_STAIN_REF if stain_ref is None else stain_ref, dev)
    ref_max = _f32(DEFAULT_MAX_CONC if max_conc_ref is None else max_conc_ref,
                   dev)
    _stains, max_c, tissue_frac, conc, _live = _stains_from_od(
        _optical_density(imgs_u8))
    conc = conc * (ref_max / max_c)[..., None]  # (B, 2, N)
    od_norm = (conc[:, None, 0] * ref[:, 0, None]
               + conc[:, None, 1] * ref[:, 1, None])  # (B, 3, N)
    out = torch.clamp(_IO * torch.exp(-od_norm.double()).float() - 1.0,
                      0.0, 255.0)
    out = out.transpose(1, 2).reshape(imgs_u8.shape).to(torch.uint8)
    keep = (tissue_frac >= min_tissue_frac)[:, None, None, None]
    return torch.where(keep, out, imgs_u8)


def macenko_normalize(img_u8: torch.Tensor, stain_ref=None, max_conc_ref=None,
                      min_tissue_frac: float = 0.05) -> torch.Tensor:
    """One (H, W, 3) uint8 image: :func:`macenko_normalize_batch` of a
    batch of one."""
    return macenko_normalize_batch(img_u8[None], stain_ref, max_conc_ref,
                                   min_tissue_frac)[0]
