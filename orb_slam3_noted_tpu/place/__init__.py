"""Place recognition: bag-of-binary-words by matmul.

Batched replacement for DBoW2 + KeyFrameDatabase
(`/root/reference/Thirdparty/DBoW2/`, `src/KeyFrameDatabase.cc`): instead of
a 10^6-leaf vocabulary tree walked per descriptor, the vocabulary is a flat
bank of W binary centroids; the transform of a whole frame is ONE bit-matmul
(descriptor bits x centroid bits -> Hamming argmin), and scoring a query
against every keyframe in the database is a second matmul over dense BoW
vectors — the inverted file becomes a (KF x W) matrix resident on device.
"""

from orb_slam3_noted_tpu.place.vocab import (  # noqa: F401
    train_vocabulary,
    transform,
    bow_vector,
)
from orb_slam3_noted_tpu.place.database import KeyFrameDatabase  # noqa: F401
