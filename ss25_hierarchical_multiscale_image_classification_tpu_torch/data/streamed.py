"""Patch extraction of a whole slide level on the device.

Counterpart of the JAX package's ``data/streamed.py``
(``extract_patches_on_device`` and its XLA program ``_extract_kernel``) as
torch ops on ``device``. The decoded level plane goes up once, into a
white-padded device buffer; on the device:

- the patch grid is a view of that buffer in the reference's x-major order;
- each cell's byte sum (int64) gives the tissue filter
  (``grid/labeling.py::tissue_sum_limit``);
- the annotation is rasterized (``grid/rasterize.py::polygons_to_mask_device``)
  into a zero-padded mask (the pad region is zero, not rasterized) and
  any-pooled into the cells' labels; without an annotation every label is 0.

The host reads back the keep mask and the labels, picks the kept cells,
and the device gathers only those patches for the download.

Differences from the JAX function: the tissue filter is the host
extractor's exact one (the JAX program's float32 mean can differ only for a
cell whose exact mean lies within float32 rounding of the threshold), and
the device gathers the kept patches instead of returning the whole grid.
:attr:`extract_patches_on_device.calls` counts the calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    PAD_FILL_VALUE,
    TISSUE_MEAN_RGB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.labeling import (
    patch_labels_from_mask,
    tissue_sum_limit,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
    pad_polygons,
    polygons_to_mask_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)

log = get_logger("data.streamed")


def upload_padded_plane(level_plane: np.ndarray, grid: PatchGrid,
                        device: torch.device) -> torch.Tensor:
    """The (PH, PW, 3) uint8 plane on ``device``, white past the image (a
    plane that fills its grid goes up as it is, with no second copy)."""
    host = torch.from_numpy(np.ascontiguousarray(level_plane, dtype=np.uint8))
    if host.shape[:2] == (grid.padded_height, grid.padded_width):
        return host.to(device)
    plane = torch.full((grid.padded_height, grid.padded_width, 3),
                       PAD_FILL_VALUE, dtype=torch.uint8, device=device)
    plane[:grid.height, :grid.width] = host.to(device)
    return plane


def cell_view(plane: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(gh, P, gw, P, 3) view of a padded plane: cell (iy, ix) is
    ``view[iy, :, ix]``."""
    ph, pw = plane.shape[:2]
    return plane.view(ph // patch_size, patch_size, pw // patch_size,
                      patch_size, 3)


#: Bytes of the int32 copy of one band of cell rows that :func:`tissue_keep`
#: sums at a time.
SUM_BAND_BYTES = 256 << 20


def tissue_keep(plane: torch.Tensor, patch_size: int,
                tissue_threshold: float) -> torch.Tensor:
    """(gw·gh,) bool in x-major order: the cell's mean ≤ threshold, from its
    exact byte sum. A reduction to another dtype first copies its input in
    that dtype, so the plane is summed in bands of cell rows: each pixel
    row of a cell in int32 (at most 1792·3·255), the rows in int64."""
    ph, pw = plane.shape[:2]
    gh, gw = ph // patch_size, pw // patch_size
    per_cell_row = patch_size * pw * 3 * 4
    band = max(1, SUM_BAND_BYTES // per_cell_row)
    sums = torch.empty((gh, gw), dtype=torch.int64, device=plane.device)
    for r0 in range(0, gh, band):
        rows = plane[r0 * patch_size:min(gh, r0 + band) * patch_size]
        rows = rows.to(torch.int32).view(-1, patch_size, gw, patch_size * 3)
        sums[r0:r0 + band] = rows.sum(dim=3).to(torch.int64).sum(dim=1)
    limit = tissue_sum_limit(tissue_threshold, patch_size * patch_size * 3)
    return (sums <= limit).T.reshape(-1)


def cell_labels(grid: PatchGrid, polygons_level0: list[np.ndarray],
                base_dims: tuple[int, int],
                device: torch.device) -> torch.Tensor:
    """(gw·gh,) int32 labels in x-major order: the annotation rasterized at
    the level, zero-padded to the grid, any-pooled per cell; all 0 without
    an annotation."""
    ps = grid.patch_size
    gh, gw = grid.padded_height // ps, grid.padded_width // ps
    if not polygons_level0:
        return torch.zeros((gw * gh,), dtype=torch.int32, device=device)
    verts, valid = pad_polygons(polygons_level0)
    mask = torch.zeros((grid.padded_height, grid.padded_width),
                       dtype=torch.uint8, device=device)
    mask[:grid.height, :grid.width] = polygons_to_mask_device(
        verts, valid, (grid.width, grid.height), base_dims, device=device)
    return patch_labels_from_mask(mask, ps).T.reshape(-1)


def extract_patches_on_device(
    level_plane: np.ndarray,
    grid: PatchGrid,
    polygons_level0: list[np.ndarray],
    base_dims: tuple[int, int],
    tissue_threshold: float = TISSUE_MEAN_RGB_THRESHOLD,
    *,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract one slide level on ``device``.

    Args:
        level_plane: (H, W, 3) uint8 decoded level plane (host).
        grid: the level's PatchGrid (stride == patch size).
        polygons_level0: tumor polygons in level-0 coords ([] ⇒ all normal).
        base_dims: (width, height) of level 0.

    Returns:
        (patches (M, P, P, 3) uint8, coords (M, 2) int32, labels (M,) int32)
        on the host, compacted to tissue cells whose top-left lies inside
        the image, in reference order.
    """
    ps = grid.patch_size
    if grid.stride != ps:
        raise ValueError("on-device extraction covers the stride==size grid")
    dev = resolve_device(device)
    extract_patches_on_device.calls += 1
    gh, gw = grid.padded_height // ps, grid.padded_width // ps
    with Timer(f"extract_on_device[{grid.num_patches} cells]", log):
        plane = upload_padded_plane(level_plane, grid, dev)
        keep = tissue_keep(plane, ps, tissue_threshold).cpu().numpy()
        labels = cell_labels(grid, polygons_level0, base_dims,
                             dev).cpu().numpy()
        # coords of the full x-major grid, then drop out-of-image and
        # non-tissue cells; the device gathers the kept patches only
        xs = np.repeat(np.arange(gw, dtype=np.int32), gh) * ps
        ys = np.tile(np.arange(gh, dtype=np.int32), gw) * ps
        inside = (xs < grid.width) & (ys < grid.height)
        sel = np.nonzero(keep & inside)[0]
        ix = torch.from_numpy(sel // gh).to(dev)
        iy = torch.from_numpy(sel % gh).to(dev)
        # advanced indices on dims 0 and 2 lead: (M, P, P, 3)
        patches = cell_view(plane, ps)[iy, :, ix].cpu().numpy()
    coords = np.stack([xs, ys], axis=1)[sel]
    return patches, coords, labels[sel]


extract_patches_on_device.calls = 0
