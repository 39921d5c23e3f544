"""Closed-form Sim(3)/SE(3) alignment (Horn's method).

Batched equivalent of the reference's `Sim3Solver::ComputeSim3`
(`/root/reference/src/Sim3Solver.cc`) and of the evaluation script's
alignment (`/root/reference/evaluation/evaluate_ate_scale.py`).  The
reference uses Horn's quaternion method; here we use the SVD form (Umeyama),
which is equivalent, batched, and maps to jnp.linalg primitives.
"""

from __future__ import annotations

import jax.numpy as jnp


def horn_sim3(
    x: jnp.ndarray,
    y: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    fix_scale: bool = False,
):
    """Least-squares similarity aligning x -> y:  y ~= s R x + t.

    Args:
      x, y: (N, 3) corresponding points.
      weights: optional (N,) nonnegative weights (use 0/1 as a validity mask
        for RANSAC with static shapes).
      fix_scale: if True returns s = 1 (SE3 alignment, stereo/RGB-D case —
        mirrors the reference's ``mbFixScale``).

    Returns:
      (R (3,3), t (3,), s ()) with y ~= s R x + t.
    """
    if weights is None:
        weights = jnp.ones(x.shape[0], dtype=x.dtype)
    wsum = jnp.maximum(jnp.sum(weights), 1e-12)
    w = (weights / wsum)[:, None]
    mx = jnp.sum(w * x, axis=0)
    my = jnp.sum(w * y, axis=0)
    xc = x - mx
    yc = y - my
    # Weighted covariance
    S = (yc * w).T @ xc  # (3,3), maps x-frame to y-frame
    U, D, Vt = jnp.linalg.svd(S)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    E = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=x.dtype)).at[2, 2].set(d)
    R = U @ E @ Vt
    var_x = jnp.sum(w * xc * xc)
    s_opt = jnp.sum(D * jnp.diagonal(E)) / jnp.maximum(var_x, 1e-12)
    s = jnp.where(jnp.asarray(fix_scale), jnp.ones_like(s_opt), s_opt)
    t = my - s * (R @ mx)
    return R, t, s
