"""Plain copy of the detection producer: greedy centroid NMS on a margin
grid, the scores squashed for the CSV, and the CSV's text.

The program turns each slide's (ny, nx) margin grid into rows
``score,x,y`` in level-0 pixels: cells above the threshold's margin, taken
greedily by the highest margin, each suppressing its 3×3 neighbourhood,
placed at the centroid of the probability mass above 0.5 in its 5×5 window
over the 4-connected positive component of the peak.
"""

from __future__ import annotations

import csv
import io
from collections import deque

import numpy as np


def sigmoid(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float32)
    pos = m >= 0
    z = np.exp(np.where(pos, -m, m))
    return np.where(pos, 1.0 / (1.0 + z), z / (1.0 + z)).astype(np.float32)


def prob_to_margin(p: float) -> float:
    p = min(max(float(p), 1e-12), 1.0 - 1e-12)
    return float(np.log(p / (1.0 - p)))


def _component(positive: np.ndarray, sy: int, sx: int) -> np.ndarray:
    keep = np.zeros_like(positive, bool)
    keep[sy, sx] = True
    q = deque([(sy, sx)])
    h, w = positive.shape
    while q:
        y, x = q.popleft()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < h and 0 <= xx < w and positive[yy, xx] \
                    and not keep[yy, xx]:
                keep[yy, xx] = True
                q.append((yy, xx))
    return keep


def detections(margins: np.ndarray, stride: int, patch: int,
               downsample: float, threshold: float, radius: int = 1,
               max_detections: int = 1000, com_radius: int = 2
               ) -> list[tuple[float, int, int]]:
    """[(score, x_level0, y_level0)] of a margin grid (see the module)."""
    field = margins.copy()
    weights = np.clip(sigmoid(margins) - 0.5, 0.0, None).astype(np.float64)
    floor = prob_to_margin(threshold)
    ny, nx = field.shape
    out = []
    while len(out) < max_detections:
        gy, gx = (int(v) for v in np.unravel_index(np.argmax(field),
                                                    field.shape))
        m = float(field[gy, gx])
        if m < floor:
            break
        cy, cx = float(gy), float(gx)
        y0, y1 = max(0, gy - com_radius), min(ny, gy + com_radius + 1)
        x0, x1 = max(0, gx - com_radius), min(nx, gx + com_radius + 1)
        w = weights[y0:y1, x0:x1].copy()
        if w[gy - y0, gx - x0] <= 0.0:
            w[:] = 0.0
        else:
            w = np.where(_component(w > 0.0, gy - y0, gx - x0), w, 0.0)
        total = float(w.sum())
        if total > 0.0:
            yy, xx = np.mgrid[y0:y1, x0:x1]
            cy = float((yy * w).sum() / total)
            cx = float((xx * w).sum() / total)
        half = patch // 2
        score = 0.5 + 0.5 * m / (1.0 + abs(m))
        out.append((float(score), int((cx * stride + half) * downsample),
                    int((cy * stride + half) * downsample)))
        field[max(0, gy - radius):gy + radius + 1,
              max(0, gx - radius):gx + radius + 1] = -np.inf
    return out


def csv_text(rows: list[tuple[float, int, int]]) -> str:
    """The rows as the CSV writer of Python's standard library writes
    them: no header, three columns."""
    buf = io.StringIO(newline="")
    writer = csv.writer(buf)
    for r in rows:
        writer.writerow(list(r))
    return buf.getvalue()
