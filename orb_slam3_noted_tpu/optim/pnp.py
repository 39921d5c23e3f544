"""Batched PnP RANSAC for relocalization.

Batched replacement for ``MLPnPsolver``
(`/root/reference/src/MLPnPsolver.cpp`, used by ``Tracking::Relocalization``
`src/Tracking.cc:3455-3623`): like MLPnP it works on bearing vectors (so it
handles fisheye), but instead of a sequential RANSAC with a nullspace-based
minimal solver, it builds all hypotheses at once: random 6-point subsets ->
batched DLT (SVD nullspace of the 2n x 12 system) -> orthonormality repair ->
bearing-angle inlier scoring of all hypotheses x all points in one pass ->
best hypothesis refined by :func:`pose_optimization` outside.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_HP = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    success: jnp.ndarray   # () bool
    Rcw: jnp.ndarray       # (3, 3)
    tcw: jnp.ndarray       # (3,)
    inliers: jnp.ndarray   # (N,) bool
    n_inliers: jnp.ndarray  # () int32


def _dlt_p6p(X: jnp.ndarray, rays: jnp.ndarray):
    """Batched DLT from 6 points. X (H, 6, 3) world; rays (H, 6, 3) z=1.

    Returns (H, 3, 3) R and (H, 3) t with orthonormality repair.
    """
    x = rays[..., 0]
    y = rays[..., 1]
    ones = jnp.ones_like(x)
    zeros = jnp.zeros_like(x)
    Xh = jnp.concatenate([X, ones[..., None]], axis=-1)  # (H, 6, 4)
    z4 = jnp.zeros_like(Xh)
    # rows: [X 0 -x*X], [0 X -y*X]
    r1 = jnp.concatenate([Xh, z4, -x[..., None] * Xh], axis=-1)  # (H, 6, 12)
    r2 = jnp.concatenate([z4, Xh, -y[..., None] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # (H, 12, 12)
    _, _, Vt = jnp.linalg.svd(A)
    p = Vt[..., -1, :]  # (H, 12)
    P = p.reshape(-1, 3, 4)
    Rraw = P[..., :3]
    traw = P[..., 3]
    # scale/orthonormalize: R = U Vt, scale = 3 / trace(S)
    U, S, Vt2 = jnp.linalg.svd(Rraw)
    det = jnp.linalg.det(U @ Vt2)
    D = jnp.zeros_like(Rraw).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    D = D.at[..., 2, 2].set(det)
    R = U @ D @ Vt2
    scale = (S[..., 0] + S[..., 1] + S[..., 2] * det) / 3.0
    # sign: pick the sign putting more sampled points in front
    t = traw / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    z = jnp.einsum("hij,hnj->hni", R, X, precision=_HP)[..., 2] + t[..., None, 2]
    flip = jnp.sum(jnp.where(z > 0, 1, -1), axis=-1) < 0
    R = jnp.where(flip[..., None, None], -R, R)
    t = jnp.where(flip[..., None], -t, t)
    # after flipping both, det may be -1: repair by re-projecting to SO(3)
    det2 = jnp.linalg.det(R)
    R = jnp.where(det2[..., None, None] < 0, -R, R)
    return R, t


@partial(jax.jit, static_argnames=("n_hyp",))
def pnp_ransac(
    Xw: jnp.ndarray,
    rays: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    cos_thresh: float = 0.99996,  # ~0.5 deg bearing error
    min_inliers: int = 12,
    n_hyp: int = 128,
) -> PnPResult:
    """RANSAC pose from 3D-2D matches. Xw (N, 3), rays (N, 3) z=1-normalized."""
    n = Xw.shape[0]
    dtype = Xw.dtype
    p = valid.astype(dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(6,), replace=False, p=p)
    )(keys)
    R, t = _dlt_p6p(Xw[idx], rays[idx])  # (H, 3, 3), (H, 3)

    # score: bearing angle between predicted and observed rays
    xc = jnp.einsum("hij,nj->hni", R, Xw, precision=_HP) + t[:, None, :]
    nrm = jnp.linalg.norm(xc, axis=-1) * jnp.linalg.norm(rays, axis=-1)[None, :]
    cosa = jnp.einsum("hni,ni->hn", xc, rays, precision=_HP) / jnp.maximum(nrm, 1e-12)
    inl = (cosa > cos_thresh) & (xc[..., 2] > 0) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    n_in = counts[best]
    return PnPResult(
        success=n_in >= min_inliers,
        Rcw=R[best],
        tcw=t[best],
        inliers=inl[best],
        n_inliers=n_in.astype(jnp.int32),
    )
