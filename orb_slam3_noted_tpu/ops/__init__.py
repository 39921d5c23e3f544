"""Feature-frontend and matching kernels (batched XLA / Pallas).

Batched device replacements for the reference's per-pixel C++ loops:

- :mod:`orb_slam3_noted_tpu.ops.image` — bilinear resize + Gaussian blur
  (reference: ``cv::resize`` / ``cv::GaussianBlur`` calls in
  `src/ORBextractor.cc:1113-1177`).
- :mod:`orb_slam3_noted_tpu.ops.fast` — FAST-9/16 corner scoring + grid NMS
  (reference: cell-FAST + quadtree in `src/ORBextractor.cc:537-1057`).
- :mod:`orb_slam3_noted_tpu.ops.orb` — IC-angle orientation + rBRIEF
  descriptors and the full pyramid extractor
  (reference: `src/ORBextractor.cc:452-477,1115-1120`).
- :mod:`orb_slam3_noted_tpu.ops.matching` — Hamming matrices (popcount and
  bit-matmul forms), mutual-NN/ratio/rotation-consistency matching, and
  windowed projection search (reference: `src/ORBmatcher.cc`).
- :mod:`orb_slam3_noted_tpu.ops.stereo` — rectified row-band stereo matching
  (reference: `src/Frame.cc:794` ``ComputeStereoMatches``).

All kernels use static shapes: keypoints are padded to per-level budgets and
carry validity masks.
"""
