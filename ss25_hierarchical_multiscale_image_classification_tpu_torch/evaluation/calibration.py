"""Combine-mode codes of the multiscale classifier's calibration.

Copy of the parts of the JAX package's ``evaluation/calibration.py`` that
slide inference reads: :data:`COMBINE_MODES`, :func:`encode_combine`,
``_LEGACY_COMBINE`` and :func:`decode_combine`, held to the originals by
exact tests. A ``hierarchical_classifier`` artifact stores its default
detection surface as the int code, since a tree of arrays carries no
strings. The fitting functions (temperatures, mode and weight selection,
the cascade operating point) come with multiscale training.
"""

from __future__ import annotations

import numpy as np

# order matches the score-column layout of
# ``infer/multiscale._combine_scores`` (COMBINE_COLUMNS): index == column.
# aux_base = the BASE (detection-grid) level's aux head alone, at the same
# magnification the single-level producer runs (max level number = most
# downsampled); ensemble_base mixes the fusion head with it.
COMBINE_MODES = ("ensemble", "fusion", "aux", "aux_base", "ensemble_base")


def encode_combine(mode: str) -> int:
    """Combine mode → int code (artifacts carry no strings)."""
    return COMBINE_MODES.index(mode)


#: earlier artifacts shipped these names for the base-level surfaces (the
#: sorted index -1 level is the MOST downsampled one, not the finest)
_LEGACY_COMBINE = {"aux_fine": "aux_base", "ensemble_fine": "ensemble_base"}


def decode_combine(value) -> str:
    """Int code (or already-decoded string) → combine mode."""
    if isinstance(value, str):
        return _LEGACY_COMBINE.get(value, value)
    return COMBINE_MODES[int(np.asarray(value))]
