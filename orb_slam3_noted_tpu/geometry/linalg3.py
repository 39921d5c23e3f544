"""Closed-form small-matrix linear algebra (batched).

``jnp.linalg.inv/solve`` lower to LU decompositions with pivoting and
sequential control flow per matrix; for large batches of tiny matrices
these adjugate/Cramer forms are pure vectorized arithmetic instead.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3(A: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Batched inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-20, jnp.where(det < 0, -1e-20, 1e-20), det)
    inv_det = (1.0 / det)[..., None, None]
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det


def solve3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve of (..., 3, 3) x = (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv3(A), b)


def solve6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve of (..., 6, 6) x = (..., 6) via 3x3 block elimination.

    Assumes the top-left 3x3 block is invertible (true for damped normal
    equations).  Avoids batched LU with pivoting.
    """
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Pinv = inv3(P)
    RPinv = jnp.einsum("...ij,...jk->...ik", R, Pinv)
    schur = S - jnp.einsum("...ij,...jk->...ik", RPinv, Q)
    x2 = solve3(schur, b2 - jnp.einsum("...ij,...j->...i", RPinv, b1))
    x1 = jnp.einsum(
        "...ij,...j->...i", Pinv, b1 - jnp.einsum("...ij,...j->...i", Q, x2)
    )
    return jnp.concatenate([x1, x2], axis=-1)
