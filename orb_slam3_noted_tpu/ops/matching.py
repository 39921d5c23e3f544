"""Binary-descriptor matching kernels.

Dense re-design of the reference's `src/ORBmatcher.cc`: instead of
per-feature candidate lists walked with scalar popcount loops
(``DescriptorDistance`` `:2561-2577`), whole cost matrices are built at once:

- :func:`hamming_matrix` — XOR + ``population_count`` on packed uint32 words
  (elementwise path, exact).
- :func:`hamming_matrix_mxu` — bits unpacked to a (N, 256) matrix so the
  Hamming distance becomes ``popA + popB - 2 A B^T``, one bf16 matmul on the
  matmul unit (used when both sides are large, e.g. place recognition).
- :func:`match_nn` — nearest neighbour with the reference's gates: TH_LOW/
  TH_HIGH absolute thresholds, best/second-best ratio (``mfNNratio``),
  optional mutual cross-check, optional rotation-consistency histogram of 30
  bins keeping the 3 largest (`:36-38`, ``ComputeThreeMaxima`` `:2515-2556`).
- :func:`search_by_projection` — window-gated matching of predicted
  projections against frame features, replacing the frame grid
  (``GetFeaturesInArea``) with a dense distance mask.

All inputs are fixed-size with validity masks; invalid entries get +inf cost.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

TH_HIGH = 100  # reference ORBmatcher::TH_HIGH
TH_LOW = 50    # reference ORBmatcher::TH_LOW
HISTO_LENGTH = 30
BIG = jnp.int32(1 << 20)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bit matrix (bit order = pack order)."""
    n = desc.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(n, 256).astype(jnp.uint8)


def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(Na, 8) x (Nb, 8) packed uint32 -> (Na, Nb) int32 Hamming distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix_mxu(bits_a: jnp.ndarray, bits_b: jnp.ndarray) -> jnp.ndarray:
    """Hamming via one matmul on unpacked bits.

    bits_*: (N, 256) uint8 (0/1). ham = popA + popB - 2 * A @ B^T.
    """
    fa = bits_a.astype(jnp.bfloat16)
    fb = bits_b.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        fa, fb, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    pa = jnp.sum(bits_a.astype(jnp.int32), axis=-1)
    pb = jnp.sum(bits_b.astype(jnp.int32), axis=-1)
    return (pa[:, None] + pb[None, :] - 2 * dot.astype(jnp.int32)).astype(jnp.int32)


class Matches(NamedTuple):
    idx: jnp.ndarray   # (Na,) int32 index into B, -1 if unmatched
    dist: jnp.ndarray  # (Na,) int32 Hamming distance (BIG if unmatched)


def _best_two(masked: jnp.ndarray):
    """(best, second, argbest) along the last axis without a sort.

    Two min/argmin passes: two streaming reductions over each row instead
    of a ``lax.top_k`` selection.
    """
    best = jnp.min(masked, axis=-1)
    idx = jnp.argmin(masked, axis=-1).astype(jnp.int32)
    n = masked.shape[-1]
    cols = jax.lax.broadcasted_iota(jnp.int32, masked.shape, masked.ndim - 1)
    masked2 = jnp.where(cols == idx[..., None], BIG, masked)
    second = jnp.min(masked2, axis=-1)
    return best, second, idx


def _rotation_consistency(ang_a, ang_b, idx, matched):
    """Keep only matches whose angle difference falls in the 3 modal bins."""
    d = ang_a - ang_b[jnp.clip(idx, 0)]
    d = jnp.mod(d, 2 * jnp.pi)
    bins = jnp.clip(
        (d * (HISTO_LENGTH / (2 * jnp.pi))).astype(jnp.int32), 0, HISTO_LENGTH - 1
    )
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[1]
    keep_bin = jnp.zeros(HISTO_LENGTH, bool).at[top3].set(True)
    # Reference drops bins below 10% of the max as well (`:2545-2553`).
    max_count = jnp.max(hist)
    keep_bin = keep_bin & (hist > 0.1 * max_count)
    return matched & keep_bin[bins]


def match_nn(
    dist: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = True,
    ang_a: jnp.ndarray | None = None,
    ang_b: jnp.ndarray | None = None,
) -> Matches:
    """Gated nearest-neighbour matching on a precomputed distance matrix."""
    masked = jnp.where(valid_a[:, None] & valid_b[None, :], dist, BIG)
    best, second, idx = _best_two(masked)
    ok = (best <= max_dist) & valid_a
    if ratio < 1.0:
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    if mutual:
        best_for_b = jnp.argmin(masked, axis=0)
        ok = ok & (best_for_b[idx] == jnp.arange(dist.shape[0]))
    if ang_a is not None and ang_b is not None:
        ok = _rotation_consistency(ang_a, ang_b, idx, ok)
    return Matches(
        idx=jnp.where(ok, idx, -1), dist=jnp.where(ok, best, BIG)
    )


def search_by_projection(
    uv_pred: jnp.ndarray,
    radius: jnp.ndarray,
    level_pred: jnp.ndarray,
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_level: jnp.ndarray,
    feat_desc: jnp.ndarray,
    feat_valid: jnp.ndarray,
    max_dist: int = TH_HIGH,
    ratio: float = 1.0,
    level_window: tuple = (-1, 1),
) -> Matches:
    """Window-gated projection matching (query points -> frame features).

    Equivalent of ``ORBmatcher::SearchByProjection``
    (`src/ORBmatcher.cc:44,2173`): each query (a map point with predicted
    pixel uv, search radius and predicted octave) is matched to the best
    frame feature inside its window and level range.

    Returns (Nq,) Matches into the frame features.
    """
    # bit-matmul: map-size x frame-size matrices become one dense
    # contraction instead of an XOR + popcount per pair
    d = hamming_matrix_mxu(unpack_bits(desc_q), unpack_bits(feat_desc))  # (Nq, Nf)
    du = uv_pred[:, None, 0] - feat_xy[None, :, 0]
    dv = uv_pred[:, None, 1] - feat_xy[None, :, 1]
    inside = (du * du + dv * dv) <= (radius[:, None] ** 2)
    lvl_ok = (feat_level[None, :] >= level_pred[:, None] + level_window[0]) & (
        feat_level[None, :] <= level_pred[:, None] + level_window[1]
    )
    gate = inside & lvl_ok & feat_valid[None, :] & valid_q[:, None]
    masked = jnp.where(gate, d, BIG)
    best, second, idx = _best_two(masked)
    ok = (best <= max_dist) & valid_q
    if ratio < 1.0:
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return Matches(idx=jnp.where(ok, idx, -1), dist=jnp.where(ok, best, BIG))


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance query per target feature.

    The reference avoids duplicates by marking target features as taken
    during its sequential scan; the batched equivalent is a segment-min over
    target indices.
    """
    idx = matches.idx
    dist = matches.dist
    tgt = jnp.clip(idx, 0)
    best_per_tgt = jnp.full((n_targets,), BIG, jnp.int32).at[tgt].min(
        jnp.where(idx >= 0, dist, BIG)
    )
    is_best = (idx >= 0) & (dist == best_per_tgt[tgt])
    # Break exact-distance ties by keeping the smallest query index.
    qidx = jnp.arange(idx.shape[0], dtype=jnp.int32)
    first_q = jnp.full((n_targets,), jnp.int32(1 << 30)).at[tgt].min(
        jnp.where(is_best, qidx, jnp.int32(1 << 30))
    )
    keep = is_best & (first_q[tgt] == qidx)
    return Matches(idx=jnp.where(keep, idx, -1), dist=jnp.where(keep, dist, BIG))
