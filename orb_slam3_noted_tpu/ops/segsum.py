"""Segment-sum strategies.

``jax.ops.segment_sum`` lowers to a scatter-add, whose row updates collide
on shared segments.  ``segment_sum_mxu`` reformulates the reduction as a
one-hot matmul, S[s, f] = sum_o 1[seg_o == s] * data[o, f]: the one-hot
operand is fused into the dot, so the reduction is one dense contraction
with no scatter at all.  Which is faster depends on the device and the
sizes; the switch below selects the path.

Env ``SLAM_SEGSUM=scatter`` forces the scatter path (A/B testing).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_IMPL = os.environ.get("SLAM_SEGSUM", "mxu")


def segment_sum_mxu(data: jnp.ndarray, seg: jnp.ndarray, num_segments: int,
                    precision=jax.lax.Precision.HIGHEST):
    """segment_sum via one one-hot matmul.

    data: (O, ...) float; seg: (O,) int32 in [0, num_segments).
    Accumulation is always f32; ``precision`` controls operand rounding
    (HIGHEST = exact f32, DEFAULT = the device's reduced-precision
    operands — ~0.4% operand rounding in bf16; fine for Hessian assembly whose
    steps are cost-checked anyway).
    """
    if _IMPL == "scatter":
        return jax.ops.segment_sum(data, seg, num_segments=num_segments)
    shape = data.shape
    O = shape[0]
    flat = data.reshape(O, -1)
    oh = (
        seg[None, :] == jnp.arange(num_segments, dtype=seg.dtype)[:, None]
    ).astype(flat.dtype)
    out = jax.lax.dot_general(
        oh, flat, (((1,), (0,)), ((), ())),
        precision=precision, preferred_element_type=jnp.float32,
    )
    return out.reshape((num_segments,) + shape[1:])
