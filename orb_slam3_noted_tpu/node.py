"""Live streaming SLAM node — the role of the reference's ROS wrappers.

The reference ships five ROS nodes (`Examples/ROS/ORB_SLAM3/src/ros_mono.cc`,
`ros_mono_inertial.cc`, `ros_stereo.cc`, `ros_rgbd.cc`,
`ros_stereo_inertial.cc`): each subscribes to image/IMU topics, buffers
messages under a mutex, synchronizes images with IMU by timestamp in a
`SyncWithImu` loop (`ros_mono_inertial.cc:141-185`), and feeds
``System::Track*`` from the loop.  Without ROS there is no roscore;
this node keeps the same shape with plain sockets and threads:

- :class:`SlamNode` owns a SLAM system (any mode `cli.build_system` can
  construct), thread-safe ``grab_image`` / ``grab_imu`` intake queues
  (the ``GrabImage``/``GrabImu`` callbacks), a sync loop that releases an
  image only once IMU coverage reaches its timestamp, and a publisher
  fan-out of per-frame pose estimates (the pose topic).
- :func:`serve` wraps a node in a length-prefixed binary TCP protocol so an
  external producer (camera driver, rosbag replayer, another process) can
  stream frames in and receive pose JSON lines back on the same socket.

Frames are processed one at a time in arrival order — the live node is the
latency-oriented driver; the throughput-oriented batched path stays in
`cli.py` / ``process_batch``.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
from collections import deque

import numpy as np

__all__ = ["SlamNode", "serve", "main"]

_INERTIAL_MODES = {"mono-inertial", "stereo-inertial",
                   "fisheye-stereo-inertial"}
_TWO_IMAGE_MODES = {"stereo", "fisheye-stereo", "rgbd", "stereo-inertial",
                    "fisheye-stereo-inertial"}


class SlamNode:
    """In-process live node: grab callbacks + sync loop + pose publisher.

    Mirrors the reference node objects (``ImageGrabber`` + ``ImuGrabber`` +
    the ``sync_thread``, `ros_mono_inertial.cc:96-185`) with one object.
    """

    def __init__(self, cfg, mode: str, realtime: bool = False):
        from orb_slam3_noted_tpu.cli import build_system, resolve_mode

        self.mode = resolve_mode(cfg, mode)
        self.slam = build_system(cfg, self.mode)
        self.two_image = self.mode in _TWO_IMAGE_MODES
        self.inertial = self.mode in _INERTIAL_MODES
        # drop-to-newest under backlog, like the stereo-inertial reference
        # node which pops the buffer down to the latest pair
        # (`ros_stereo_inertial.cc` keeps only the freshest images); the
        # mono node processes every frame — default off.
        self.realtime = realtime

        self._lock = threading.Lock()          # mBufMutex
        self._img_buf: deque = deque()         # (t, img[, img2])
        self._imu_buf: deque = deque()         # (t, acc3, gyr3)
        self._have_work = threading.Event()
        self._stop = threading.Event()
        self._subs: list = []
        self._thread: threading.Thread | None = None
        self._frame_id = 0
        self.n_dropped = 0
        self.n_published = 0

    # ---- intake callbacks (thread-safe; the Grab* topic callbacks) ----

    def grab_image(self, img, t: float, img2=None):
        """Queue a frame (``ImageGrabber::GrabImage``).  For two-image
        modes ``img2`` is the right / depth image."""
        if self.two_image and img2 is None:
            raise ValueError(f"mode {self.mode} needs img2")
        with self._lock:
            self._img_buf.append((float(t), img, img2))
        self._have_work.set()

    def grab_imu(self, t: float, acc, gyr):
        """Queue one IMU sample (``ImuGrabber::GrabImu``)."""
        with self._lock:
            self._imu_buf.append(
                (float(t), np.asarray(acc, np.float64),
                 np.asarray(gyr, np.float64))
            )
        self._have_work.set()

    def subscribe(self, fn):
        """Register a pose-subscriber callback ``fn(record_dict)``."""
        self._subs.append(fn)

    # ---- sync loop -----------------------------------------------------

    def _imu_ready(self, img_t: float) -> bool:
        # release an image only when IMU coverage reaches its timestamp
        # (`ros_mono_inertial.cc:150`: tImb >= tIm guard)
        return bool(self._imu_buf) and self._imu_buf[-1][0] >= img_t

    def spin_once(self) -> bool:
        """Process at most one queued frame; returns True if one ran."""
        with self._lock:
            if not self._img_buf:
                return False
            if self.realtime and len(self._img_buf) > 1:
                dropped = len(self._img_buf) - 1
                self.n_dropped += dropped
                while len(self._img_buf) > 1:
                    self._img_buf.popleft()
            t, img, img2 = self._img_buf[0]
            if self.inertial and not self._imu_ready(t):
                return False
            self._img_buf.popleft()
            if self.inertial:
                samples = []
                while self._imu_buf and self._imu_buf[0][0] <= t:
                    samples.append(self._imu_buf.popleft())

        fid = self._frame_id
        self._frame_id += 1
        if self.inertial:
            if samples:
                imu_t = np.array([s[0] for s in samples])
                acc = np.stack([s[1] for s in samples])
                gyr = np.stack([s[2] for s in samples])
            else:
                imu_t = np.zeros((0,)); acc = np.zeros((0, 3))
                gyr = np.zeros((0, 3))
            if self.two_image:
                rec = self.slam.process(img, img2, fid, t=t, acc=acc,
                                        gyr=gyr, imu_t=imu_t)
            else:
                rec = self.slam.process(img, fid, t=t, acc=acc, gyr=gyr,
                                        imu_t=imu_t)
        elif self.two_image:
            rec = self.slam.process(img, img2, fid)
        else:
            rec = self.slam.process(img, fid)
        self._publish(rec, t)
        return True

    def _publish(self, rec, t: float):
        if rec is None:
            msg = {"t": t, "state": "NOT_INITIALIZED"}
        else:
            # camera-to-world, the frame the reference publishes on its
            # pose topic (`ros_mono.cc` AR branch publishes Twc)
            Rwc = np.asarray(rec.Rcw).T
            twc = -Rwc @ np.asarray(rec.tcw)
            msg = {
                "t": t, "frame_id": int(rec.frame_id), "state": rec.state,
                "n_inliers": int(rec.n_inliers),
                "Rwc": Rwc.tolist(), "twc": twc.tolist(),
            }
        self.n_published += 1
        for fn in self._subs:
            fn(msg)

    def _loop(self):
        while not self._stop.is_set():
            if not self.spin_once():
                self._have_work.wait(timeout=0.05)
                self._have_work.clear()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the sync loop; with ``drain`` process the backlog after.

        The thread is joined BEFORE draining — ``slam.process`` mutates
        host state and must never run from two threads at once (the
        reference serializes through LocalMapping/LoopClosing queues for
        the same reason).
        """
        self._stop.set()
        self._have_work.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if drain:
            while self.spin_once():
                pass


# ---- TCP transport -----------------------------------------------------
#
# One duplex connection.  Inbound messages, each ``4-byte tag + u32 length
# + payload``:
#   IMG0  payload = f64 t, u32 w, u32 h, w*h u8 grayscale  (starts a frame)
#   IMG1  payload = u32 w, u32 h, w*h u8 — right image for two-image modes
#   DPT1  payload = u32 w, u32 h, w*h f32 — depth image (rgbd)
#   IMUS  payload = u32 n, n × 7 f64 (t, ax, ay, az, gx, gy, gz)
#   DONE  payload empty — drain, reply trajectory summary, close
# Outbound: POSE + u32 length + JSON record per processed frame, then on
# DONE one FINI + u32 length + JSON {"n_frames", "n_tracked"}.


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    while buf.tell() < n:
        chunk = sock.recv(n - buf.tell())
        if not chunk:
            raise ConnectionError("stream closed mid-message")
        buf.write(chunk)
    return buf.getvalue()


def _send_msg(sock: socket.socket, tag: bytes, payload: bytes):
    sock.sendall(tag + struct.pack("<I", len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    head = _read_exact(sock, 8)
    tag, n = head[:4], struct.unpack("<I", head[4:])[0]
    return tag, _read_exact(sock, n)


def _decode_u8_image(payload: bytes, off: int = 0):
    w, h = struct.unpack_from("<II", payload, off)
    img = np.frombuffer(
        payload, np.uint8, count=w * h, offset=off + 8
    ).reshape(h, w)
    return img.astype(np.float32)


def serve(node: SlamNode, host: str = "127.0.0.1", port: int = 0,
          ready_event: threading.Event | None = None,
          _bound: list | None = None):
    """Accept ONE producer connection and stream poses back over it.

    Returns when the producer sends DONE or disconnects.  ``port=0`` binds
    an ephemeral port, reported via ``_bound.append((host, port))``.
    """
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    if _bound is not None:
        _bound.append(srv.getsockname())
    if ready_event is not None:
        ready_event.set()
    conn, _ = srv.accept()
    send_lock = threading.Lock()

    def pose_out(msg):
        with send_lock:
            try:
                _send_msg(conn, b"POSE", json.dumps(msg).encode())
            except OSError:
                pass

    node.subscribe(pose_out)
    node.start()
    pending_img = None  # (t, left) awaiting its IMG1/DPT1 pair
    try:
        while True:
            tag, payload = _recv_msg(conn)
            if tag == b"IMG0":
                t = struct.unpack_from("<d", payload)[0]
                img = _decode_u8_image(payload, 8)
                if node.two_image:
                    pending_img = (t, img)
                else:
                    node.grab_image(img, t)
            elif tag == b"IMG1":
                t, left = pending_img
                node.grab_image(left, t, img2=_decode_u8_image(payload))
                pending_img = None
            elif tag == b"DPT1":
                w, h = struct.unpack_from("<II", payload)
                depth = np.frombuffer(
                    payload, np.float32, count=w * h, offset=8
                ).reshape(h, w)
                t, left = pending_img
                node.grab_image(left, t, img2=depth)
                pending_img = None
            elif tag == b"IMUS":
                (n,) = struct.unpack_from("<I", payload)
                arr = np.frombuffer(
                    payload, np.float64, count=n * 7, offset=8
                ).reshape(n, 7)
                for row in arr:
                    node.grab_imu(row[0], row[1:4], row[4:7])
            elif tag == b"DONE":
                node.stop(drain=True)
                n_ok = sum(
                    1 for r in node.slam.trajectory if r.state == "OK"
                )
                fini = {"n_frames": len(node.slam.trajectory),
                        "n_tracked": n_ok, "n_dropped": node.n_dropped}
                with send_lock:
                    _send_msg(conn, b"FINI", json.dumps(fini).encode())
                break
            else:
                raise ValueError(f"unknown message tag {tag!r}")
    finally:
        node.stop(drain=False)
        conn.close()
        srv.close()


def main(argv=None):
    """``python -m orb_slam3_noted_tpu.node --settings S.yaml --mode mono
    --port 7777`` — the `rosrun ORB_SLAM3 Mono voc settings` analogue."""
    import argparse

    from orb_slam3_noted_tpu.io.yaml_compat import load_settings
    from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(description="live streaming SLAM node")
    ap.add_argument("--settings", required=True)
    ap.add_argument("--mode", default="mono")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7777)
    ap.add_argument("--realtime", action="store_true",
                    help="drop backlog to the newest frame")
    args = ap.parse_args(argv)
    cfg = load_settings(args.settings)
    if isinstance(cfg, tuple):  # inertial settings return (cfg, imu_params)
        cfg = cfg[0]
    node = SlamNode(cfg, args.mode, realtime=args.realtime)
    ready, bound = threading.Event(), []
    th = threading.Thread(
        target=serve, args=(node, args.host, args.port),
        kwargs=dict(ready_event=ready, _bound=bound), daemon=True,
    )
    th.start()
    ready.wait()
    host, port = bound[0]
    print(f"listening on {host}:{port} mode={node.mode}", flush=True)
    th.join()


if __name__ == "__main__":
    main()
