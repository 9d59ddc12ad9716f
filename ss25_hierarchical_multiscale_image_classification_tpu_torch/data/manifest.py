"""Patch manifests: one record per extracted patch.

Copy of the JAX package's ``data/manifest.py`` (``PatchRecord``,
``PatchManifest``, ``manifest_path``, ``load_or_scan_manifest``), held to it
by exact tests. A manifest is a table with columns

    slide, level, x, y, label, store, path, row

where ``store`` is "png" (``path`` is the PNG file) or "packed" (``path`` is
the pack file, ``row`` the index into its memmap). It persists as parquet,
as in the JAX package; ``pyarrow`` is imported only when a parquet manifest
is loaded or saved. Where pyarrow is missing (the card's machine), a
manifest saved to a ``.npz`` path persists as numpy columns instead, and
:func:`load_or_scan_manifest` reads ``manifest.npz`` when a level has no
``manifest.parquet``; the JAX package reads parquet only. The stages that
write a level's manifest (extraction, hard-negative mining) save it to
:func:`level_manifest_path`: ``manifest.parquet`` where pyarrow imports,
``manifest.npz`` elsewhere, and read it back with
:func:`load_level_manifest`.
Reference-layout PNG directories (``{slide}_x{x}_y{y}_{label}.png``) are
scanned as well.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Iterable, Sequence

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
    """Columnar patch manifest, loaded from parquet or a PNG-tree scan."""

    COLUMNS = ("slide", "level", "x", "y", "label", "store", "path", "row")

    def __init__(self, records: Sequence[PatchRecord] | None = None):
        self._records: list[PatchRecord] = list(records or [])

    # -- construction ---------------------------------------------------
    def append(self, rec: PatchRecord) -> None:
        self._records.append(rec)

    def extend(self, recs: Iterable[PatchRecord]) -> None:
        self._records.extend(recs)

    # -- access ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, i: int) -> PatchRecord:
        return self._records[i]

    def __iter__(self):
        return iter(self._records)

    @property
    def records(self) -> list[PatchRecord]:
        return self._records

    def labels(self) -> np.ndarray:
        return np.array([r.label for r in self._records], dtype=np.int32)

    def slides(self) -> list[str]:
        return sorted({r.slide for r in self._records})

    def filter(self, fn) -> "PatchManifest":
        return PatchManifest([r for r in self._records if fn(r)])

    def for_slides(self, slide_names: Iterable[str]) -> "PatchManifest":
        names = set(slide_names)
        return self.filter(lambda r: r.slide in names)

    def class_counts(self) -> dict[int, int]:
        labels = self.labels()
        return {c: int((labels == c).sum()) for c in np.unique(labels)}

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Parquet, or numpy columns when ``path`` ends in ``.npz``."""
        if path.endswith(".npz"):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, **{name: np.array([getattr(r, name)
                                              for r in self._records])
                              for name in self.COLUMNS})
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cols = {
            "slide": pa.array([r.slide for r in self._records], pa.string()),
            "level": pa.array([r.level for r in self._records], pa.int32()),
            "x": pa.array([r.x for r in self._records], pa.int64()),
            "y": pa.array([r.y for r in self._records], pa.int64()),
            "label": pa.array([r.label for r in self._records], pa.int32()),
            "store": pa.array([r.store for r in self._records], pa.string()),
            "path": pa.array([r.path for r in self._records], pa.string()),
            "row": pa.array([r.row for r in self._records], pa.int64()),
        }
        pq.write_table(pa.table(cols), path)

    @classmethod
    def load(cls, path: str) -> "PatchManifest":
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                d = {name: z[name].tolist() for name in cls.COLUMNS}
        else:
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


def manifest_npz_path(patches_dir: str, level: int) -> str:
    """The numpy manifest of a level, for machines without pyarrow."""
    return os.path.join(patches_dir, f"level_{level}", "manifest.npz")


def pyarrow_available() -> bool:
    """Whether pyarrow imports here (the card's machine has none)."""
    try:
        import pyarrow.parquet  # noqa: F401
    except ImportError:
        return False
    return True


def level_manifest_path(patches_dir: str, level: int) -> str:
    """Where a stage saves the level's manifest: parquet
    (the JAX package's file) where pyarrow imports, else numpy."""
    if pyarrow_available():
        return manifest_path(patches_dir, level)
    return manifest_npz_path(patches_dir, level)


def load_level_manifest(patches_dir: str, level: int) -> PatchManifest:
    """The level's saved manifest, parquet or numpy, whichever exists
    (parquet first), else an empty one. Unlike :func:`load_or_scan_manifest`
    it does not scan a PNG tree, as the JAX extractor does not."""
    for mpath in (manifest_path(patches_dir, level),
                  manifest_npz_path(patches_dir, level)):
        if os.path.exists(mpath):
            return PatchManifest.load(mpath)
    return PatchManifest()


def load_or_scan_manifest(patches_dir: str, level: int) -> PatchManifest:
    """Load the manifest for a level (parquet, else numpy), falling back to
    a PNG-directory scan for interop with reference-produced patch trees."""
    for mpath in (manifest_path(patches_dir, level),
                  manifest_npz_path(patches_dir, level)):
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
