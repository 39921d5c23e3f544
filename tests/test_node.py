"""Live streaming node tests — the ROS-wrapper role (SURVEY §2.1 ROS nodes).

The reference's nodes buffer topic messages and feed ``System::Track*``
from a sync loop (`Examples/ROS/ORB_SLAM3/src/ros_mono.cc`,
`ros_mono_inertial.cc:141-185`).  These tests drive the
equivalent: in-process grab callbacks, the image/IMU timestamp sync
guard, and the full TCP round-trip with poses streamed back.
"""

import json
import socket
import struct
import threading

import numpy as np

from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu.node import SlamNode, _recv_msg, _send_msg, serve
from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

W, H = 320, 240


def _cfg():
    cam = Camera(PINHOLE, (260.0, 260.0, W / 2 - 0.5, H / 2 - 0.5))
    return SlamConfig(
        camera=cam, width=W, height=H, n_features=600,
        max_keyframes=32, max_map_points=4096,
        local_window=5, kf_max_interval=10,
    )


def _render_seq(n):
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n, forward=0.03, yaw0=0.45)
    return [room.render(Rwc, twc, (260.0, 260.0, W / 2 - 0.5, H / 2 - 0.5),
                        W, H) for Rwc, twc in poses]


def test_node_inproc_mono():
    node = SlamNode(_cfg(), "mono")
    got = []
    node.subscribe(got.append)
    imgs = _render_seq(20)
    for i, img in enumerate(imgs):
        node.grab_image(img, i / 20.0)
    node.start()
    node.stop(drain=True)  # drains the backlog synchronously
    assert node.n_published == len(imgs)
    states = [m["state"] for m in got]
    assert states.count("OK") >= 10, states
    ok = next(m for m in got if m["state"] == "OK")
    # Twc published (world frame), orthonormal rotation
    R = np.asarray(ok["Rwc"])
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_node_imu_sync_guard():
    """An inertial frame must wait for IMU coverage past its timestamp
    (`ros_mono_inertial.cc:150`)."""
    node = SlamNode(_cfg(), "mono-inertial")
    img = _render_seq(1)[0]
    node.grab_image(img, 1.0)
    assert node.spin_once() is False  # no IMU yet: frame held
    node.grab_imu(0.95, [0, 0, 9.81], [0, 0, 0])
    assert node.spin_once() is False  # IMU coverage ends before the frame
    node.grab_imu(1.05, [0, 0, 9.81], [0, 0, 0])
    assert node.spin_once() is True
    assert node.n_published == 1


def test_node_realtime_drops_backlog():
    node = SlamNode(_cfg(), "mono", realtime=True)
    imgs = _render_seq(6)
    for i, img in enumerate(imgs):
        node.grab_image(img, i / 20.0)
    assert node.spin_once() is True  # keeps only the newest queued frame
    assert node.n_dropped == 5 and node.n_published == 1


def test_node_tcp_round_trip():
    cfg = _cfg()
    node = SlamNode(cfg, "mono")
    ready = threading.Event()
    bound = []
    th = threading.Thread(
        target=serve, args=(node,),
        kwargs=dict(port=0, ready_event=ready, _bound=bound), daemon=True,
    )
    th.start()
    assert ready.wait(5.0)
    host, port = bound[0]
    cli = socket.create_connection((host, port), timeout=30)

    imgs = _render_seq(16)
    for i, img in enumerate(imgs):
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        payload = (struct.pack("<dII", i / 20.0, W, H) + u8.tobytes())
        _send_msg(cli, b"IMG0", payload)
    _send_msg(cli, b"DONE", b"")

    poses, fini = [], None
    while fini is None:
        tag, payload = _recv_msg(cli)
        msg = json.loads(payload)
        if tag == b"POSE":
            poses.append(msg)
        elif tag == b"FINI":
            fini = msg
    cli.close()
    th.join(timeout=30)
    assert fini["n_frames"] == len(imgs)
    assert len(poses) == len(imgs)
    assert fini["n_tracked"] >= 8, fini
