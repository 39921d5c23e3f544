"""Two-view triangulation (batched DLT).

Batched equivalent of the reference's triangulation in
`/root/reference/src/TwoViewReconstruction.cc` (``Triangulate``: SVD of the
4x4 DLT system) and `src/CameraModels/KannalaBrandt8.cpp`
(``TriangulateMatches``), redesigned as a batched closed form: instead of a
per-point 4x4 SVD we solve the equivalent 3x3 normal equations of the
midpoint/DLT system, which vmaps and tiles cleanly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry.linalg3 import solve3


def triangulate_dlt(
    ray1: jnp.ndarray,
    ray2: jnp.ndarray,
    R21: jnp.ndarray,
    t21: jnp.ndarray,
) -> jnp.ndarray:
    """Triangulate from bearing rays in two cameras.

    Args:
      ray1: (..., 3) unit-norm (or z-normalized) bearing rays in camera 1.
      ray2: (..., 3) bearing rays in camera 2.
      R21, t21: pose of camera 1 in camera 2: x2 = R21 @ x1 + t21.

    Returns:
      (..., 3) points in camera-1 frame (depth may be negative for bad pairs —
      callers gate on cheirality as the reference does).
    """
    # DLT rows: cross(ray, P x_h) = 0 for P1 = [I|0], P2 = [R21|t21].
    # Build A (4, 4) per point and solve via normal equations on the
    # inhomogeneous 3-vector (x, y, z) with w = 1 — avoids per-point SVD.
    zeros = jnp.zeros_like(ray1[..., 0])
    ones = jnp.ones_like(zeros)

    def two_rows(ray, P_R, P_t):
        # rows: x * P[2] - z_c * P[0]; y * P[2] - z_c * P[1] with ray=(x,y,z_c)
        x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
        r0 = x[..., None] * P_R[..., 2, :] - z[..., None] * P_R[..., 0, :]
        c0 = x * P_t[..., 2] - z * P_t[..., 0]
        r1 = y[..., None] * P_R[..., 2, :] - z[..., None] * P_R[..., 1, :]
        c1 = y * P_t[..., 2] - z * P_t[..., 1]
        return jnp.stack([r0, r1], axis=-2), jnp.stack([c0, c1], axis=-1)

    eyeR = jnp.broadcast_to(jnp.eye(3, dtype=ray1.dtype), ray1.shape[:-1] + (3, 3))
    zt = jnp.zeros(ray1.shape[:-1] + (3,), dtype=ray1.dtype)
    A1, b1 = two_rows(ray1, eyeR, zt)
    R21b = jnp.broadcast_to(R21, ray1.shape[:-1] + (3, 3))
    t21b = jnp.broadcast_to(t21, ray1.shape[:-1] + (3,))
    A2, b2 = two_rows(ray2, R21b, t21b)
    A = jnp.concatenate([A1, A2], axis=-2)  # (..., 4, 3)
    b = -jnp.concatenate([b1, b2], axis=-1)  # (..., 4)

    # Full f32 precision: a reduced-precision matmul (bf16 or TF32 operands)
    # is far too coarse for the squared system A^T A.
    AtA = jnp.einsum("...ki,...kj->...ij", A, A, precision=jax.lax.Precision.HIGHEST)
    Atb = jnp.einsum("...ki,...k->...i", A, b, precision=jax.lax.Precision.HIGHEST)
    # Regularize to keep the solve defined for degenerate (parallel-ray) pairs.
    AtA = AtA + 1e-9 * jnp.eye(3, dtype=A.dtype)
    return solve3(AtA, Atb)


def parallax_cos(
    ray1: jnp.ndarray, ray2_in_1: jnp.ndarray
) -> jnp.ndarray:
    """Cosine of the angle between bearing rays expressed in a common frame."""
    n1 = jnp.linalg.norm(ray1, axis=-1)
    n2 = jnp.linalg.norm(ray2_in_1, axis=-1)
    return jnp.sum(ray1 * ray2_in_1, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
