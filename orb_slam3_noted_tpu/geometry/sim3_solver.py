"""Sim(3) RANSAC from 3D-3D map-point correspondences.

Batched equivalent of ``Sim3Solver`` (reference `src/Sim3Solver.cc`:
Horn closed-form on random 3-point sets + reprojection-based inlier check +
final refinement).  All hypotheses are built and scored in one batch; the
refinement is IRLS-weighted Horn on the inlier set.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry.horn import horn_sim3

_HP = jax.lax.Precision.HIGHEST


class Sim3Result(NamedTuple):
    success: jnp.ndarray   # () bool
    R: jnp.ndarray         # (3, 3)  maps frame-1 coords to frame-2 coords
    t: jnp.ndarray         # (3,)
    s: jnp.ndarray         # ()
    inliers: jnp.ndarray   # (N,) bool
    n_inliers: jnp.ndarray  # () int32


@partial(jax.jit, static_argnames=("fix_scale", "n_hyp", "min_inliers"))
def sim3_ransac(
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    inlier_thresh: float = 0.05,
    fix_scale: bool = False,
    min_inliers: int = 20,
    n_hyp: int = 128,
) -> Sim3Result:
    """Estimate x2 ~= s R x1 + t from padded correspondences.

    x1/x2: (N, 3) matched 3D points in the two keyframes' camera frames
    (the reference likewise aligns camera-frame point sets).
    inlier_thresh: metric distance threshold, scaled by point depth (the
    reference uses reprojection chi2; a depth-proportional 3D gate behaves
    similarly and avoids needing the camera here).
    """
    n = x1.shape[0]
    dtype = x1.dtype
    p = valid.astype(dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(3,), replace=False, p=p)
    )(keys)  # (H, 3)

    R_h, t_h, s_h = jax.vmap(lambda i: horn_sim3(x1[i], x2[i], fix_scale=fix_scale))(
        idx
    )
    # score all hypotheses: |s R x1 + t - x2| < thresh * depth
    pred = s_h[:, None, None] * jnp.einsum("hij,nj->hni", R_h, x1, precision=_HP) + t_h[:, None, :]
    err = jnp.linalg.norm(pred - x2[None], axis=-1)
    scale_gate = inlier_thresh * jnp.maximum(
        jnp.linalg.norm(x2, axis=-1), 1.0
    )
    inl = (err < scale_gate[None, :]) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    inl_best = inl[best]

    # refine: weighted Horn on inliers, 2 IRLS rounds
    w = inl_best.astype(dtype)
    R, t, s = horn_sim3(x1, x2, weights=w, fix_scale=fix_scale)
    for _ in range(2):
        pred = s * (x1 @ R.T) + t
        err = jnp.linalg.norm(pred - x2, axis=-1)
        w = ((err < scale_gate) & valid).astype(dtype)
        R, t, s = horn_sim3(x1, x2, weights=w, fix_scale=fix_scale)
    pred = s * (x1 @ R.T) + t
    err = jnp.linalg.norm(pred - x2, axis=-1)
    inliers = (err < scale_gate) & valid
    n_in = jnp.sum(inliers).astype(jnp.int32)
    return Sim3Result(
        success=n_in >= min_inliers, R=R, t=t, s=s, inliers=inliers, n_inliers=n_in
    )
