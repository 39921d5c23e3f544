"""Per-stage timing instrumentation (the reference's REGISTER_TIMES).

The reference gates ``std::chrono`` spans around every pipeline stage behind
a compile-time flag (`/root/reference/include/Config.h:4`) and dumps
mean/std per stage at shutdown (``Tracking::PrintTimeStats``,
`src/Tracking.cc:194-251`, `src/System.cc:414-416`).  Same taxonomy here so
numbers stay comparable:

    extract, stereo_match, preintegrate, pose_pred, track_local_map,
    new_kf_decision, triangulate, fuse, local_ba, kf_cull,
    loop_detect, loop_correct, gba

Enable with ``StageTimer.enabled = True`` (or the ``SLAM_TIMES`` env
var); disabled timers cost one attribute check.  ``block`` controls whether
a stage waits for device completion (jax dispatch is async — without
blocking, a span measures dispatch, not compute).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class StageTimer:
    enabled = bool(int(os.environ.get("SLAM_TIMES", "0")))

    def __init__(self):
        self.spans = defaultdict(list)

    @contextmanager
    def stage(self, name: str, block=None):
        if not StageTimer.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block is not None:
            try:
                import jax

                jax.block_until_ready(block)
            except Exception:
                pass
        self.spans[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, v in self.spans.items():
            a = np.asarray(v)
            out[name] = {
                "n": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "std_ms": float(a.std() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def print_stats(self, file=None):
        """Reference ``Tracking::PrintTimeStats`` analogue."""
        rows = self.summary()
        lines = ["stage                     n    mean ms     std ms    total s"]
        for name in sorted(rows):
            r = rows[name]
            lines.append(
                f"{name:<22} {r['n']:>5} {r['mean_ms']:>10.3f}"
                f" {r['std_ms']:>10.3f} {r['total_s']:>10.3f}"
            )
        text = "\n".join(lines)
        print(text, file=file)
        return text

    def save(self, path: str):
        """Dump per-stage means to a file (reference ``ExecTimeMean.txt``)."""
        with open(path, "w") as f:
            self.print_stats(file=f)


GLOBAL_TIMER = StageTimer()


# ---------------------------------------------------------------------------
# Saturation counters (SURVEY "no silent caps"): every static-capacity
# truncation — local-BA anchor-observation cap, chain-BA landmark
# compaction, map-point allocator — reports its overflow here instead of
# silently dropping data.  Device code calls :func:`report_saturation`
# (a jax.debug.callback: runs on the host when the dispatch executes);
# ``print_saturation`` surfaces the counts next to the stage table.
# ---------------------------------------------------------------------------

SATURATION = defaultdict(int)


def _bump(name: str, amount):
    a = int(amount)
    if a > 0:
        if SATURATION[name] == 0:
            import sys

            print(
                f"[saturation] {name}: capacity exceeded by {a} "
                "(first occurrence; see --times for totals)",
                file=sys.stderr,
            )
        SATURATION[name] += a


def report_saturation(name: str, overflow):
    """Call from INSIDE jitted code with a device scalar ``overflow``
    (0 = no truncation).  Fires a host callback that counts and warns on
    first occurrence."""
    import jax

    jax.debug.callback(lambda v, n=name: _bump(n, v), overflow)


def print_saturation(file=None):
    if not SATURATION:
        return
    lines = ["saturated cap              dropped (total)"]
    for name in sorted(SATURATION):
        lines.append(f"{name:<26} {SATURATION[name]:>10}")
    print("\n".join(lines), file=file)


class MetricsStream:
    """Structured JSONL metric stream (SURVEY §5 metrics/logging).

    The reference's observability is stderr prints + the REGISTER_TIMES
    dump at shutdown; a headless deployment needs a machine-readable
    stream instead.  One :meth:`emit` per pipeline beat (frame batch, KF
    insertion, loop event) appends a JSON line holding:

    - monotonic sequence number + wall-clock timestamp,
    - stage-timer DELTAS since the previous emit (only stages that ran),
    - cumulative saturation counters,
    - caller gauges (n_kf, n_mp, tracking state, imu_stage, ...).

    Timer deltas come from ``GLOBAL_TIMER`` span counts, so the stream
    composes with ``--times`` without double bookkeeping.
    """

    def __init__(self, path: str, timer: StageTimer | None = None):
        self._f = open(path, "a", buffering=1)
        self._timer = timer if timer is not None else GLOBAL_TIMER
        self._seq = 0
        self._seen: dict = {}  # stage -> span count at last emit

    def emit(self, event: str, **gauges):
        stages = {}
        for name, spans in self._timer.spans.items():
            k = len(spans)
            k0 = self._seen.get(name, 0)
            if k > k0:
                new = spans[k0:]
                stages[name] = {
                    "n": len(new),
                    "total_ms": round(sum(new) * 1e3, 3),
                }
                self._seen[name] = k
        rec = dict(gauges)
        # reserved keys win over caller gauges
        rec.update({"seq": self._seq, "ts": time.time(), "event": event})
        if stages:
            rec["stages"] = stages
        if SATURATION:
            rec["saturation"] = dict(SATURATION)
        self._seq += 1
        import json

        self._f.write(json.dumps(rec) + "\n")

    def gauges_for(self, slam) -> dict:
        """Standard system gauges pulled off any SLAM facade."""
        g = {
            "n_kf": int(getattr(slam, "n_kf", 0)),
            "n_mp": int(getattr(slam, "n_mp", 0)),
            "state": getattr(slam, "state", "?"),
            "frames_total": int(getattr(slam, "frames_total", 0)),
        }
        stage = getattr(slam, "imu_stage", None)
        if stage is not None:
            g["imu_stage"] = int(stage)
        return g

    def close(self):
        self._f.close()
