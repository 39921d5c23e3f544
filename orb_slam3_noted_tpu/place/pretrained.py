"""Shipped pretrained vocabulary loader.

The reference loads the ~10^6-word ``ORBvoc.txt`` at startup
(`/root/reference/src/System.cc:85-101`); this build ships a 32k-word bank
trained offline by ``scripts/train_vocab.py`` (hierarchical k-majority over
descriptors harvested from many synthetic viewpoints, flattened for exact
matmul argmin transform).  ``load_default_vocabulary`` returns it, or ``None``
when the asset is absent (callers fall back to on-the-fly training).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "vocab32k.npz")


@lru_cache(maxsize=1)
def load_default_vocabulary():
    """((W, 8) uint32 packed centroid bank, (W,) f32 idf or None).

    Returns (None, None) if the asset is not shipped.  ``idf`` mirrors the
    word weights DBoW2 stores in the vocabulary file
    (`Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h` setNodeWeights: idf from
    the training corpus).
    """
    path = os.path.abspath(_ASSET)
    if not os.path.exists(path):
        return None, None
    with np.load(path) as f:
        vocab = f["vocab"]
        idf = f["idf"].astype(np.float32) if "idf" in f.files else None
    return vocab, idf
