"""chip_smoke.py off the GPU: it must refuse to run, and its comparison
helpers must accept results within tolerance and reject the rest."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (JAX on the CPU), or no package beside the script: exit code
    is not 0 and no ``"ok": true`` line is printed."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _good_stats():
    return {
        "fast_l0_max_abs": 0.0, "score_max_abs": 1.9e-3, "blur_max_abs": 9e-4,
        "kp_identical": 0.995, "desc_hamming_mean": 0.1,
        "uR_median_abs": 0.004, "stereo_flags_agree": 0.999,
    }


def test_frontend_within_tolerance_accepted():
    assert C.frontend_violations(_good_stats()) == []


@pytest.mark.parametrize("key,value", [
    ("fast_l0_max_abs", 1.0),
    ("score_max_abs", 3e-3),
    ("blur_max_abs", float("nan")),
    ("kp_identical", 0.98),
    ("desc_hamming_mean", 0.6),
    ("uR_median_abs", 0.02),
    ("stereo_flags_agree", 0.95),
])
def test_frontend_outside_tolerance_rejected(key, value):
    stats = dict(_good_stats(), **{key: value})
    assert C.frontend_violations(stats) == [key]


def test_agreement_helpers():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 700, size=(2, 100, 2)).astype(np.float32)
    lvl = rng.integers(0, 8, size=(2, 100))
    val = np.ones((2, 100), bool)
    share, pairs = C.keypoint_agreement(xy, lvl, val, xy, lvl, val)
    assert share == 1.0 and len(pairs) == 200
    xy2 = xy.copy()
    xy2[0, :3] += 1.0  # three keypoints moved by a pixel
    share, pairs = C.keypoint_agreement(xy, lvl, val, xy2, lvl, val)
    assert share == pytest.approx(197 / 200) and len(pairs) == 197

    d = rng.integers(0, 2**32, size=(50, 8), dtype=np.uint32)
    assert C.mean_hamming(d, d) == 0.0
    d2 = d.copy()
    d2[:, 0] ^= np.uint32(1)  # one flipped bit each
    assert C.mean_hamming(d, d2) == 1.0

    u = rng.uniform(0, 700, size=200)
    v = np.ones(200, bool)
    med, agree = C.stereo_agreement(u, v, u + 0.003, v, v)
    assert med == pytest.approx(0.003) and agree == 1.0
    v2 = v.copy()
    v2[:10] = False
    assert C.stereo_agreement(u, v, u, v2, v)[1] == pytest.approx(0.95)
    assert C.max_abs_diff(np.zeros(3), np.array([0.0, -2.0, 1.0])) == 2.0


@pytest.mark.parametrize("tracked,ate,bad", [
    (118, 0.020, []),
    (116, 0.0249, []),    # tracked - 2; ate within ref + 0.01
    (115, 0.020, ["tracked"]),
    (118, 0.026, ["ate_m"]),
    (118, float("nan"), ["ate_m"]),
])
def test_lap_bounds(tracked, ate, bad):
    ref = {"tracked": 118, "ate_m": 0.015}
    assert C.lap_bounds(ref)["max_ate_m"] == pytest.approx(0.025)
    assert C.lap_violations(tracked, ate, ref) == bad


def test_main_path_imports_only_core_packages():
    """The GPU host has numpy, scipy, optax, chex, einops beside JAX; the
    main path and the smoke must not pull the optional IO/viewer packages."""
    code = (
        "import sys, chip_smoke\n"
        "import orb_slam3_noted_tpu.pipeline.system\n"
        "import orb_slam3_noted_tpu.pipeline.inertial_system\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'cv2', 'PIL', 'yaml', 'matplotlib'}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
