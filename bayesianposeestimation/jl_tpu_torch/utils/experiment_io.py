"""Experiment-level I/O: a BOP target's image and mesh, TUM trajectories,
ROS messages and depth streams (host code, NumPy only).

Counterpart of ``jl_tpu/utils/experiment_io.py``. A depth stream is an
``.npz`` with ``depth`` [F, H, W] float32 metres, ``K`` [3, 3], ``width``,
``height`` and optionally ``stamps``, ``gt_t`` [F, 3], ``gt_q`` [F, 4]
(w, x, y, z): the same keys as the JAX package's, so a stream written by
either package loads in the other. ``convert_rosbag`` turns a ROS1 bag into
such a stream through the port's own ``rosbag`` reader.
"""

from __future__ import annotations

import numpy as np

from ..camera import CvCamera
from . import bop
from .decimate import triangle_budget_for_resolution

__all__ = [
    "load_img_mesh",
    "load_tum",
    "save_tum",
    "camera_from_info",
    "ros_depth_img",
    "ros_pose",
    "load_depth_stream",
    "save_depth_stream",
    "convert_rosbag",
]


def load_img_mesh(row, params, decimate_mesh=True):
    """Depth image and visible mask of a BOP target row at the render size
    (params.width x params.height), and its object mesh, decimated to the
    triangle budget of that size unless ``decimate_mesh`` is False."""
    depth_img = bop.load_depth_image(row, params.width, params.height)
    mask_img = bop.load_mask_image(row, params.width, params.height)
    budget = (triangle_budget_for_resolution(params.width, params.height)
              if decimate_mesh else None)
    return depth_img, mask_img, bop.load_mesh(row, decimate_to=budget)


def load_tum(filename):
    """Read a TUM trajectory: (stamps [N], translations [N, 3], unit
    quaternions [N, 4] as w, x, y, z; the file stores x, y, z, w)."""
    data = np.atleast_2d(np.loadtxt(filename))
    q = np.stack([data[:, 7], data[:, 4], data[:, 5], data[:, 6]], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return data[:, 0], data[:, 1:4], q


def save_tum(filename, stamps, ts, qs):
    """Write a TUM trajectory: one ``stamp tx ty tz qx qy qz qw`` row per pose
    (quaternions arrive as w, x, y, z)."""
    qs = np.asarray(qs)
    rows = np.column_stack([stamps, np.asarray(ts), qs[:, 1], qs[:, 2], qs[:, 3], qs[:, 0]])
    np.savetxt(filename, rows, fmt="%.9g")


def camera_from_info(camera_info: dict) -> CvCamera:
    """CvCamera from a sensor_msgs/CameraInfo-like dict with 'K' (row-major
    3x3), 'width' and 'height'."""
    K = np.asarray(camera_info["K"], float).ravel()
    return CvCamera(width=int(camera_info["width"]), height=int(camera_info["height"]),
                    f_x=K[0], f_y=K[4], c_x=K[2], c_y=K[5], s=K[1])


def ros_depth_img(msg: dict) -> np.ndarray:
    """Depth image [H, W] float32 in metres from a sensor_msgs/Image-like dict
    ('encoding' 16UC1 in millimetres or 32FC1 in metres, 'data', 'width',
    'height')."""
    w, h = int(msg["width"]), int(msg["height"])
    enc = msg["encoding"]
    if enc == "16UC1":
        img = np.frombuffer(msg["data"], np.uint16).astype(np.float32) / 1000.0
    elif enc == "32FC1":
        img = np.frombuffer(msg["data"], np.float32)
    else:
        raise ValueError(f"unsupported encoding {enc}")
    return img.reshape(h, w)


def ros_pose(msg: dict):
    """(t [3], unit q [4] as w, x, y, z) from a geometry_msgs/PoseStamped-like
    dict."""
    p, o = msg["position"], msg["orientation"]
    q = np.asarray([o["w"], o["x"], o["y"], o["z"]], float)
    return np.asarray([p["x"], p["y"], p["z"]], float), q / np.linalg.norm(q)


def save_depth_stream(path, depth_imgs, camera: CvCamera, stamps=None, gt_ts=None,
                      gt_qs=None):
    """Write a depth stream: [F, H, W] float32 metres and the intrinsics, with
    the stamps and the ground-truth trajectory where given."""
    K = np.asarray([[camera.f_x, camera.s, camera.c_x], [0.0, camera.f_y, camera.c_y],
                    [0.0, 0.0, 1.0]], np.float32)
    data = dict(depth=np.asarray(depth_imgs, np.float32), K=K, width=camera.width,
                height=camera.height)
    if stamps is not None:
        data["stamps"] = np.asarray(stamps)
    if gt_ts is not None:
        data["gt_t"] = np.asarray(gt_ts, np.float32)
        data["gt_q"] = np.asarray(gt_qs, np.float32)
    np.savez_compressed(path, **data)


def load_depth_stream(path):
    """A stream written by ``save_depth_stream``: a dict with ``depth``
    [F, H, W], ``camera`` (CvCamera) and, where present, ``stamps``, ``gt_t``
    and ``gt_q``."""
    with np.load(path) as f:
        K = f["K"]
        out = dict(depth=f["depth"],
                   camera=CvCamera(width=int(f["width"]), height=int(f["height"]),
                                   f_x=float(K[0, 0]), f_y=float(K[1, 1]),
                                   c_x=float(K[0, 2]), c_y=float(K[1, 2]),
                                   s=float(K[0, 1])))
        for k in ("stamps", "gt_t", "gt_q"):
            if k in f.files:
                out[k] = f[k]
    return out


def convert_rosbag(bag_path, out_path, depth_topic, camera_info_topic, pose_topic=None):
    """Convert a ROS1 bag into a depth stream at ``out_path``: the first
    camera info on ``camera_info_topic``, every image on ``depth_topic``
    (stamped by its record time) and, with ``pose_topic``, the ground-truth
    poses. Returns ``out_path``."""
    from .rosbag import read_bag

    topics = {depth_topic, camera_info_topic}
    if pose_topic:
        topics.add(pose_topic)
    depths, stamps, gt_t, gt_q = [], [], [], []
    camera = None
    for topic, _msgtype, stamp_ns, msg in read_bag(bag_path, topics):
        if topic == camera_info_topic and camera is None:
            camera = camera_from_info(dict(K=np.asarray(msg["K"]), width=msg["width"],
                                           height=msg["height"]))
        elif topic == depth_topic:
            depths.append(ros_depth_img(msg))
            stamps.append(stamp_ns * 1e-9)
        elif pose_topic and topic == pose_topic:
            t, q = ros_pose(msg)
            gt_t.append(t)
            gt_q.append(q)
    if camera is None or not depths:
        raise ValueError(f"{bag_path}: no camera info on {camera_info_topic} or no "
                         f"images on {depth_topic}")
    save_depth_stream(out_path, np.stack(depths), camera, np.asarray(stamps),
                      np.asarray(gt_t) if gt_t else None, np.asarray(gt_q) if gt_q else None)
    return out_path
