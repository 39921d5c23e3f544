"""FAST-9/16 corner detection as dense whole-image kernels.

Dense re-design of the reference's cell-wise OpenCV FAST with quadtree
distribution (`/root/reference/src/ORBextractor.cc:537-1057`
``ComputeKeyPointsOctTree`` / ``DistributeOctTree``):

- The segment test runs densely over the whole level as 16 shifted images and
  windowed ring minima (elementwise, no per-pixel branching).
- The score is the classic "max over contiguous 9-arcs of the min margin",
  i.e. the largest threshold at which the pixel is still a corner.
- The dual-threshold fallback (iniThFAST=20 -> minThFAST=7 when a cell is
  empty, `:767-799,960-967`) becomes a per-cell threshold select.
- ``DistributeOctTree`` (keep best corner per spatial node until the budget is
  met) becomes: 3x3 NMS, per-cell top-k, then global top-N — the batched
  analogue with static shapes.

All outputs are fixed-size with validity masks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, in ring order (dy, dx), matching the standard
# FAST-16 circle layout.
CIRCLE_16 = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC = 9  # contiguous arc length for FAST-9/16


def fast_score(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9/16 corner score map.

    score(p) = max over the 16 contiguous 9-arcs of min(margin) where margin is
    (ring - center) for bright arcs and (center - ring) for dark arcs; a pixel
    is a corner at threshold t iff score > t.

    img: (H, W) float32. Returns (H, W) float32 (<=0 where not a corner at any
    threshold). Borders (3 px) are invalid — callers mask them.
    """
    center = img
    rolled = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in CIRCLE_16],
        axis=0,
    )  # ring[k][y, x] = img[y + dy_k, x + dx_k]
    d = rolled - center[None]  # (16, H, W)

    def windowed_min(x, window):
        # circular windowed min over `window` consecutive ring positions in
        # O(log window) steps: m covers [k, k+covered-1]; rolling by -s and
        # taking the min extends coverage to [k, k+covered+s-1] for s<=covered.
        m = x
        covered = 1
        while covered < window:
            s = min(covered, window - covered)
            m = jnp.minimum(m, jnp.roll(m, -s, axis=0))
            covered += s
        return m

    bright = jnp.max(windowed_min(d, ARC), axis=0)
    dark = jnp.max(windowed_min(-d, ARC), axis=0)
    return jnp.maximum(bright, dark)


def _maxpool3x3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one pyramid level."""

    xy: jnp.ndarray      # (K, 2) float32, (x, y) at this level's resolution
    score: jnp.ndarray   # (K,) float32 FAST score
    valid: jnp.ndarray   # (K,) bool


@partial(jax.jit, static_argnames=("n_out", "cell", "th_high", "th_low", "border"))
def detect_level(
    score_map: jnp.ndarray,
    n_out: int,
    cell: int = 32,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border: int = 16,
) -> Keypoints:
    """Select up to n_out spatially-distributed corners from a score map.

    Mirrors the reference policy: try iniThFAST per cell, fall back to
    minThFAST in cells where nothing passes the high threshold, then
    distribute by keeping the best-response corners per spatial bucket
    (`src/ORBextractor.cc:767-799` and ``DistributeOctTree``).
    """
    h, w = score_map.shape
    neg = jnp.float32(-1e30)

    # border + low-threshold mask, then 3x3 NMS
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    in_border = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    s = jnp.where((score_map > th_low) & in_border, score_map, neg)
    is_peak = score_map >= _maxpool3x3(score_map)
    s = jnp.where(is_peak, s, neg)

    # pad to cell multiples
    ph = (h + cell - 1) // cell * cell
    pw = (w + cell - 1) // cell * cell
    s_pad = jnp.full((ph, pw), neg, dtype=s.dtype).at[:h, :w].set(s)
    ncy, ncx = ph // cell, pw // cell
    cells = s_pad.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )

    # per-cell dual threshold: if the cell has any score > th_high, require
    # th_high there; otherwise accept th_low
    cell_max = jnp.max(cells, axis=1, keepdims=True)
    cell_th = jnp.where(cell_max > th_high, th_high, th_low)
    cells = jnp.where(cells > cell_th, cells, neg)

    # per-cell top-k candidates, then global top-n_out
    k_per_cell = max(1, min(cell * cell, 4 * n_out // max(ncy * ncx, 1) + 2))
    cand_s, cand_i = jax.lax.top_k(cells, k_per_cell)  # (nc, k)
    # flat index back to padded image coords
    cy = jnp.arange(ncy * ncx) // ncx
    cx = jnp.arange(ncy * ncx) % ncx
    iy = cy[:, None] * cell + cand_i // cell
    ix = cx[:, None] * cell + cand_i % cell

    flat_s = cand_s.reshape(-1)
    flat_y = iy.reshape(-1)
    flat_x = ix.reshape(-1)
    top_s, top_idx = jax.lax.top_k(flat_s, n_out)
    ky = flat_y[top_idx]
    kx = flat_x[top_idx]
    valid = top_s > neg / 2
    # (No sub-pixel refinement: a quadratic fit of the FAST score peak is
    # biased — measured WORSE end-to-end ATE than integer corners, and
    # OpenCV ORB keeps integer corners too.)
    xy = jnp.stack([kx, ky], axis=-1).astype(jnp.float32)
    return Keypoints(xy=xy, score=jnp.where(valid, top_s, 0.0), valid=valid)


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Per-level feature budgets, geometric with ratio 1/scale_factor.

    Mirrors the reference's ``mnFeaturesPerLevel`` computation
    (`src/ORBextractor.cc:433-444`): each coarser level gets 1/1.2 of the
    previous level's budget; the last level absorbs the remainder.
    """
    factor = 1.0 / scale_factor
    n_desired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets = []
    total = 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        total += b
        n_desired *= factor
    budgets.append(max(n_features - total, 0))
    return budgets
