"""Patch manifests: one record per extracted patch.

Copy of the JAX package's ``data/manifest.py`` (``PatchRecord``,
``PatchManifest``, ``manifest_path``, ``load_or_scan_manifest``), held to it
by exact tests. A manifest is a table with columns

    slide, level, x, y, label, store, path, row

where ``store`` is "png" (``path`` is the PNG file) or "packed" (``path`` is
the pack file, ``row`` the index into its memmap). It persists as parquet;
``pyarrow`` is imported only when a manifest is loaded, so the rest works
where it is missing (an in-memory manifest over a packed store).
Reference-layout PNG directories (``{slide}_x{x}_y{y}_{label}.png``) are
scanned as well.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Sequence

import numpy as np

#: Label names of the reference's PNG file names (the JAX package's
#: ``grid/labeling.py::LABEL_NAMES``).
LABEL_NAMES: dict[int, str] = {0: "normal", 1: "tumor"}

_FNAME_RE = re.compile(r"^(?P<slide>.+)_x(?P<x>\d+)_y(?P<y>\d+)_(?P<label>normal|tumor)\.png$")


@dataclasses.dataclass(frozen=True)
class PatchRecord:
    slide: str
    level: int
    x: int
    y: int
    label: int  # 0 normal / 1 tumor
    store: str  # "png" | "packed"
    path: str
    row: int = -1  # row in the pack file when store == "packed"

    @property
    def patch_name(self) -> str:
        """Reference file name of the patch."""
        return f"{self.slide}_x{self.x}_y{self.y}_{LABEL_NAMES[self.label]}.png"


class PatchManifest:
    """Columnar patch manifest, loaded from parquet or a PNG-tree scan.
    (Writing, and the slide filters, come with patch extraction and the
    classifier trainer.)"""

    COLUMNS = ("slide", "level", "x", "y", "label", "store", "path", "row")

    def __init__(self, records: Sequence[PatchRecord] | None = None):
        self._records: list[PatchRecord] = list(records or [])

    # -- access ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, i: int) -> PatchRecord:
        return self._records[i]

    def __iter__(self):
        return iter(self._records)

    def labels(self) -> np.ndarray:
        return np.array([r.label for r in self._records], dtype=np.int32)

    def class_counts(self) -> dict[int, int]:
        labels = self.labels()
        return {c: int((labels == c).sum()) for c in np.unique(labels)}

    # -- persistence ------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "PatchManifest":
        import pyarrow.parquet as pq

        table = pq.read_table(path)
        d = {name: table.column(name).to_pylist() for name in cls.COLUMNS}
        recs = [
            PatchRecord(
                slide=d["slide"][i],
                level=int(d["level"][i]),
                x=int(d["x"][i]),
                y=int(d["y"][i]),
                label=int(d["label"][i]),
                store=d["store"][i],
                path=d["path"][i],
                row=int(d["row"][i]),
            )
            for i in range(len(d["slide"]))
        ]
        return cls(recs)

    @classmethod
    def from_png_dir(cls, level_dir: str, level: int) -> "PatchManifest":
        """Build a manifest by scanning a reference-layout PNG directory
        (``patches/level_{L}/{slide}/{slide}_x{x}_y{y}_{label}.png``)."""
        recs = []
        for path in sorted(
            glob.glob(os.path.join(level_dir, "**", "*.png"), recursive=True)
        ):
            m = _FNAME_RE.match(os.path.basename(path))
            if not m:
                continue
            recs.append(
                PatchRecord(
                    slide=m.group("slide"),
                    level=level,
                    x=int(m.group("x")),
                    y=int(m.group("y")),
                    label=1 if m.group("label") == "tumor" else 0,
                    store="png",
                    path=path,
                )
            )
        return cls(recs)


def manifest_path(patches_dir: str, level: int) -> str:
    return os.path.join(patches_dir, f"level_{level}", "manifest.parquet")


def load_or_scan_manifest(patches_dir: str, level: int) -> PatchManifest:
    """Load the manifest for a level, falling back to a PNG-directory scan for
    interop with reference-produced patch trees."""
    mpath = manifest_path(patches_dir, level)
    if os.path.exists(mpath):
        return PatchManifest.load(mpath)
    return PatchManifest.from_png_dir(
        os.path.join(patches_dir, f"level_{level}"), level
    )


def patches_extracted(data, level: int) -> bool:
    """Stage gate of the CLI (``patches_extracted`` of the JAX package's
    ``io/download.py``): a manifest, or a PNG tree, with rows at ``level``
    under ``data.patches_dir``. Anything that fails on the way is "no"."""
    try:
        return len(load_or_scan_manifest(data.patches_dir, level)) > 0
    except Exception:
        return False
