"""Rectified stereo matching: row-band Hamming + SAD subpixel refinement.

Batched re-design of ``Frame::ComputeStereoMatches``
(`/root/reference/src/Frame.cc:794-963`): the per-left-keypoint candidate
scan becomes one (NL, NR) masked Hamming matrix (row band ±2·scale, octave
±1, disparity in [0, bf/b], best < (TH_HIGH+TH_LOW)/2), and the sliding SAD
refinement becomes a batched gather of 11x11 left patches and 11x21 right
strips at the keypoint's pyramid level, an 11-way L1 comparison, and the
same parabola subpixel fit with the same acceptance gates (edge-of-range
rejected, |delta| <= 1, disparity clamped at 0.01) plus the reference's
median-based outlier filter (1.5 x 1.4 x median SAD).

Also: ``stereo_from_depth`` for RGB-D (`src/Frame.cc` ComputeStereoFromRGBD).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_noted_tpu.ops import matching as M
from orb_slam3_noted_tpu.ops.orb import FrameFeatures, scale_factors

_W = 5   # half SAD window (11x11)
_L = 5   # max slide (+-5 px)


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray  # (NL,) refined right-image u at level 0 (-1 if none)
    depth: jnp.ndarray    # (NL,) bf/disparity (-1 if none)
    valid: jnp.ndarray    # (NL,) bool


def _gather_patch(img, cy, cx, h, w):
    """(K, h, w) patches centered at integer (cy, cx), clamped at borders."""
    H, W = img.shape
    dy = jnp.arange(-(h // 2), h // 2 + 1)
    dx = jnp.arange(-(w // 2), w // 2 + 1)
    yy = jnp.clip(cy[:, None, None] + dy[None, :, None], 0, H - 1)
    xx = jnp.clip(cx[:, None, None] + dx[None, None, :], 0, W - 1)
    return img[yy, xx]


@partial(jax.jit, static_argnames=("n_levels", "scale_factor", "bf", "baseline"))
def match_stereo(
    left: FrameFeatures,
    right: FrameFeatures,
    pyr_left: tuple,
    pyr_right: tuple,
    bf: float,
    baseline: float,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> StereoMatches:
    """Match left features to right features on a rectified pair.

    pyr_left/pyr_right: tuples of per-level images (from
    :func:`orb_slam3_noted_tpu.ops.image.build_pyramid`) — needed for the SAD
    refinement at the keypoint's own pyramid level.
    """
    NL = left.xy.shape[0]
    sf = jnp.asarray(scale_factors(n_levels, scale_factor), left.xy.dtype)
    inv_sf = 1.0 / sf

    max_d = bf / baseline
    th_orb = (M.TH_HIGH + M.TH_LOW) // 2

    # ---- candidate gating + Hamming best match ----
    with jax.named_scope("stereo_hamming"):
        d = M.hamming_matrix(left.desc, right.desc)  # (NL, NR)
    row_tol = 2.0 * sf[right.level]              # reference: 2 * right scale
    dv = jnp.abs(left.xy[:, None, 1] - right.xy[None, :, 1])
    row_ok = dv <= row_tol[None, :]
    lvl_ok = jnp.abs(left.level[:, None] - right.level[None, :]) <= 1
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    gate = row_ok & lvl_ok & disp_ok & left.valid[:, None] & right.valid[None, :]
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx_r = jnp.argmin(masked, axis=1)
    have = best < th_orb

    # ---- SAD subpixel at the left keypoint's level, via a pyramid ATLAS ----
    # Looping the 8 levels would gather (NL, 11, 21) patches PER level
    # (masked for the other levels' keypoints) — 8x redundant gathers.
    # Instead the levels are stacked into one tall (sum h_l, W0) image per
    # side and every keypoint gathers once from its own level's row band.
    lvl = left.level
    uL0 = left.xy[:, 0]
    uR0 = right.xy[idx_r, 0]
    vL0 = left.xy[:, 1]
    dtype = left.xy.dtype

    H0, W0 = pyr_left[0].shape[-2], pyr_left[0].shape[-1]
    hs = [int(p.shape[-2]) for p in pyr_left]
    ws = [int(p.shape[-1]) for p in pyr_left]
    row_off = np.concatenate([[0], np.cumsum(hs)])[:n_levels]
    atlas_l = jnp.concatenate(
        [jnp.pad(p, ((0, 0), (0, W0 - w))) for p, w in zip(pyr_left, ws)], axis=0
    )
    atlas_r = jnp.concatenate(
        [jnp.pad(p, ((0, 0), (0, W0 - w))) for p, w in zip(pyr_right, ws)], axis=0
    )
    sx_t = jnp.asarray([W0 / w for w in ws], dtype)
    sy_t = jnp.asarray([H0 / h for h in hs], dtype)
    off_t = jnp.asarray(row_off, jnp.int32)
    h_t = jnp.asarray(hs, jnp.int32)
    w_t = jnp.asarray(ws, jnp.int32)

    sx = sx_t[lvl]
    sy = sy_t[lvl]
    cu = jnp.round((uL0 + 0.5) / sx - 0.5).astype(jnp.int32)
    cv = jnp.round((vL0 + 0.5) / sy - 0.5).astype(jnp.int32)
    cur = jnp.round((uR0 + 0.5) / sx - 0.5).astype(jnp.int32)

    # gather SAD: 11x11 left patches and 11x21 right strips, clamped to the
    # level interior (FAST margins keep real keypoints inside; the clamp
    # only protects invalid/padded rows)
    with jax.named_scope("sad"):
        dy = jnp.arange(-_W, _W + 1)
        yy = jnp.clip(cv[:, None] + dy[None, :], 0, h_t[lvl][:, None] - 1)
        yy = yy + off_t[lvl][:, None]                           # (NL, 11)
        dxl = jnp.arange(-_W, _W + 1)
        xxl = jnp.clip(cu[:, None] + dxl[None, :], 0, w_t[lvl][:, None] - 1)
        dxr = jnp.arange(-(_W + _L), _W + _L + 1)
        xxr = jnp.clip(cur[:, None] + dxr[None, :], 0, w_t[lvl][:, None] - 1)
        patchL = atlas_l[yy[:, :, None], xxl[:, None, :]]       # (NL, 11, 11)
        strip = atlas_r[yy[:, :, None], xxr[:, None, :]]        # (NL, 11, 21)

        # SAD for the 11 horizontal shifts
        sads = []
        for inc in range(2 * _L + 1):
            sads.append(
                jnp.sum(
                    jnp.abs(patchL - strip[:, :, inc : inc + 2 * _W + 1]),
                    axis=(1, 2),
                )
            )
        sads = jnp.stack(sads, axis=1)  # (NL, 11)
    k = jnp.argmin(sads, axis=1)
    interior = (k > 0) & (k < 2 * _L)
    km = jnp.clip(k, 1, 2 * _L - 1)
    d1 = jnp.take_along_axis(sads, (km - 1)[:, None], 1)[:, 0]
    d2 = jnp.take_along_axis(sads, km[:, None], 1)[:, 0]
    d3 = jnp.take_along_axis(sads, (km + 1)[:, None], 1)[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = jnp.where(jnp.abs(denom) > 1e-9, (d1 - d3) / (2.0 * denom), 0.0)
    good_delta = (delta >= -1.0) & (delta <= 1.0) & interior
    u_lvl = cur.astype(dtype) + (km - _L) + delta
    uR_best = (u_lvl + 0.5) * sx - 0.5  # inverse half-pixel mapping
    sad_best = jnp.take_along_axis(sads, km[:, None], 1)[:, 0]

    ok_all = have & good_delta
    u_best = jnp.where(ok_all, uR_best, -1.0)
    sad_best = jnp.where(ok_all, sad_best, jnp.inf)

    disparity = uL0 - u_best
    in_range = (disparity >= 0.0) & (disparity < max_d)
    # clamp tiny/negative disparity like the reference
    disparity = jnp.where(disparity <= 0.0, 0.01, disparity)
    u_final = jnp.where(disparity <= 0.01, uL0 - 0.01, u_best)
    ok = ok_all & in_range

    # ---- median SAD outlier filter (1.5 * 1.4 * median) ----
    sadv = jnp.where(ok, sad_best, jnp.inf)
    n_ok = jnp.sum(ok)
    sorted_sad = jnp.sort(sadv)
    med = sorted_sad[jnp.clip(n_ok // 2, 0, NL - 1)]
    keep = ok & (sad_best < 1.5 * 1.4 * med)

    depth = jnp.where(keep, bf / disparity, -1.0)
    return StereoMatches(
        u_right=jnp.where(keep, u_final, -1.0),
        depth=depth,
        valid=keep,
    )


@jax.jit
def stereo_from_depth(
    feats: FrameFeatures, depth_img: jnp.ndarray, bf: float
) -> StereoMatches:
    """RGB-D: read depth at each keypoint, derive the virtual right coord."""
    xi = jnp.clip(feats.xy[:, 0].astype(jnp.int32), 0, depth_img.shape[1] - 1)
    yi = jnp.clip(feats.xy[:, 1].astype(jnp.int32), 0, depth_img.shape[0] - 1)
    dpt = depth_img[yi, xi]
    ok = (dpt > 0) & feats.valid
    return StereoMatches(
        u_right=jnp.where(ok, feats.xy[:, 0] - bf / jnp.maximum(dpt, 1e-6), -1.0),
        depth=jnp.where(ok, dpt, -1.0),
        valid=ok,
    )
