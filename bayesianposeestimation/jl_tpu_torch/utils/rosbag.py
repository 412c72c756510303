"""Minimal native ROS1 bag (v2.0) reader and writer: no ROS stack required.

The port's own copy of ``jl_tpu/utils/rosbag.py`` (host code: ``struct``,
``bz2`` and NumPy only), so that the port reads and writes the same bags
without importing the JAX package. It parses the subset the trackers need:
sensor_msgs/Image, sensor_msgs/CameraInfo, geometry_msgs/PoseStamped.

Bag format (http://wiki.ros.org/Bags/Format/2.0): a magic line followed by
records ``<u32 header_len><header><u32 data_len><data>`` where the header is
a sequence of ``<u32 len>name=value`` fields. Message payloads use ROS1
little-endian serialization. Chunks (op=0x05) may be 'none' or 'bz2'
compressed; both are handled (bz2 via the stdlib).

The writer emits spec-shaped bags (bag-header record + one uncompressed
chunk with connection and message records): enough for this reader and for
``rosbag play``-style sequential readers; it skips the index records, which
are only needed for random access.
"""

from __future__ import annotations

import bz2
import struct
from pathlib import Path

import numpy as np

__all__ = ["read_bag", "write_bag", "bag_messages"]

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# --------------------------------------------------------------------------- #
# Record plumbing
# --------------------------------------------------------------------------- #


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _build_header(fields: dict) -> bytes:
    out = b""
    for name, value in fields.items():
        item = name.encode() + b"=" + value
        out += struct.pack("<I", len(item)) + item
    return out


def _records(buf: bytes, off: int = 0):
    """Yield (header_fields, data) records from a byte buffer."""
    n = len(buf)
    while off < n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


# --------------------------------------------------------------------------- #
# ROS1 message (de)serialization for the subset we need
# --------------------------------------------------------------------------- #


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n):
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return np.asarray(v)

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n].decode(errors="replace")
        self.off += n
        return s

    def raw(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def ros_header(self):
        seq = self.u32()
        secs, nsecs = self.u32(), self.u32()
        frame_id = self.string()
        return dict(seq=seq, stamp=secs + nsecs * 1e-9, frame_id=frame_id)


def _parse_image(buf: bytes) -> dict:
    r = _Reader(buf)
    header = r.ros_header()
    height, width = r.u32(), r.u32()
    encoding = r.string()
    _is_bigendian = r.u8()
    _step = r.u32()
    data = r.raw(r.u32())
    return dict(header=header, height=height, width=width, encoding=encoding,
                data=data)


def _parse_camera_info(buf: bytes) -> dict:
    r = _Reader(buf)
    header = r.ros_header()
    height, width = r.u32(), r.u32()
    _model = r.string()
    d = r.f64s(r.u32())
    K = r.f64s(9)
    _R = r.f64s(9)
    _P = r.f64s(12)
    return dict(header=header, height=height, width=width, K=K, D=d)


def _parse_pose_stamped(buf: bytes) -> dict:
    r = _Reader(buf)
    header = r.ros_header()
    px, py, pz = r.f64(), r.f64(), r.f64()
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    return dict(header=header,
                position=dict(x=px, y=py, z=pz),
                orientation=dict(x=qx, y=qy, z=qz, w=qw))


_PARSERS = {
    "sensor_msgs/Image": _parse_image,
    "sensor_msgs/CameraInfo": _parse_camera_info,
    "geometry_msgs/PoseStamped": _parse_pose_stamped,
}


def _serialize_image(msg: dict) -> bytes:
    out = _ser_ros_header(msg.get("header", {}))
    out += struct.pack("<II", msg["height"], msg["width"])
    out += _ser_string(msg["encoding"])
    out += struct.pack("<BI", 0, msg["width"] * _bytes_per_px(msg["encoding"]))
    data = bytes(msg["data"])
    out += struct.pack("<I", len(data)) + data
    return out


def _bytes_per_px(encoding):
    return {"16UC1": 2, "32FC1": 4}.get(encoding, 1)


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _ser_ros_header(h: dict) -> bytes:
    stamp = float(h.get("stamp", 0.0))
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", int(h.get("seq", 0)), secs, nsecs) + _ser_string(
        h.get("frame_id", ""))


def _serialize_camera_info(msg: dict) -> bytes:
    out = _ser_ros_header(msg.get("header", {}))
    out += struct.pack("<II", msg["height"], msg["width"])
    out += _ser_string("plumb_bob")
    d = np.asarray(msg.get("D", np.zeros(5)), float)
    out += struct.pack("<I", d.size) + d.astype("<f8").tobytes()
    out += np.asarray(msg["K"], "<f8").tobytes()
    out += np.eye(3, dtype="<f8").tobytes()
    P = np.zeros((3, 4))
    P[:, :3] = np.asarray(msg["K"], float).reshape(3, 3)
    out += P.astype("<f8").tobytes()
    out += struct.pack("<II", 0, 0)  # binning
    out += struct.pack("<IIIIB", 0, 0, 0, 0, 0)  # roi
    return out


def _serialize_pose_stamped(msg: dict) -> bytes:
    out = _ser_ros_header(msg.get("header", {}))
    p, o = msg["position"], msg["orientation"]
    out += struct.pack("<7d", p["x"], p["y"], p["z"],
                       o["x"], o["y"], o["z"], o["w"])
    return out


_SERIALIZERS = {
    "sensor_msgs/Image": _serialize_image,
    "sensor_msgs/CameraInfo": _serialize_camera_info,
    "geometry_msgs/PoseStamped": _serialize_pose_stamped,
}


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #


def read_bag(path, topics=None):
    """Yield (topic, msgtype, timestamp_ns, msg_dict) in file order.

    ``topics``: optional collection restricting the output. Unknown message
    types are skipped (only the tracker-relevant types are parsed).
    """
    buf = Path(path).read_bytes()
    if buf[:len(MAGIC)] != MAGIC:
        raise ValueError(f"not a ROS1 v2.0 bag: {path}")
    connections = {}  # conn id -> (topic, msgtype)

    def handle(header, data):
        op = header.get("op", b"\x00")[0]
        if op == OP_CONNECTION:
            conn_id = struct.unpack("<I", header["conn"])[0]
            inner = _parse_header(data)
            topic = header.get("topic", inner.get("topic", b"")).decode()
            msgtype = inner.get("type", b"").decode()
            connections[conn_id] = (topic, msgtype)
        elif op == OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "bz2":
                payload = bz2.decompress(data)
            elif comp == "none":
                payload = data
            else:
                raise ValueError(f"unsupported chunk compression {comp!r}")
            for h2, d2 in _records(payload):
                yield from handle(h2, d2)
        elif op == OP_MSG:
            conn_id = struct.unpack("<I", header["conn"])[0]
            # Bag 2.0 'time' header field is secs(u32) + nsecs(u32), NOT a
            # u64 nanosecond count.
            secs, nsecs = struct.unpack("<II", header["time"])
            stamp = secs * 1_000_000_000 + nsecs
            topic, msgtype = connections.get(conn_id, ("", ""))
            if topics is not None and topic not in topics:
                return
            parser = _PARSERS.get(msgtype)
            if parser is None:
                return
            yield topic, msgtype, stamp, parser(data)

    for header, data in _records(buf, len(MAGIC)):
        yield from handle(header, data)


bag_messages = read_bag


def write_bag(path, messages):
    """Write a minimal ROS1 v2.0 bag.

    ``messages``: iterable of (topic, msgtype, timestamp_ns, msg_dict) with
    msgtype in sensor_msgs/Image, sensor_msgs/CameraInfo,
    geometry_msgs/PoseStamped. One uncompressed chunk, no index records.
    """
    messages = list(messages)
    conn_ids = {}
    chunk = b""

    def record(header_fields, data):
        h = _build_header(header_fields)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data

    for topic, msgtype, _, _ in messages:
        if (topic, msgtype) not in conn_ids:
            cid = len(conn_ids)
            conn_ids[(topic, msgtype)] = cid
            inner = _build_header({
                "topic": topic.encode(),
                "type": msgtype.encode(),
                "md5sum": b"*",
                "message_definition": b"",
            })
            chunk += record({"op": bytes([OP_CONNECTION]),
                             "conn": struct.pack("<I", cid),
                             "topic": topic.encode()}, inner)
    for topic, msgtype, stamp_ns, msg in messages:
        data = _SERIALIZERS[msgtype](msg)
        stamp_ns = int(stamp_ns)
        chunk += record({"op": bytes([OP_MSG]),
                         "conn": struct.pack("<I", conn_ids[(topic, msgtype)]),
                         "time": struct.pack(
                             "<II", stamp_ns // 1_000_000_000,
                             stamp_ns % 1_000_000_000)}, data)

    out = MAGIC
    out += record({"op": bytes([OP_BAG_HEADER]),
                   "index_pos": struct.pack("<Q", 0),
                   "conn_count": struct.pack("<I", len(conn_ids)),
                   "chunk_count": struct.pack("<I", 1)},
                  b" " * 4096)  # spec: bag header padded to 4 KiB
    out += record({"op": bytes([OP_CHUNK]),
                   "compression": b"none",
                   "size": struct.pack("<I", len(chunk))}, chunk)
    Path(path).write_bytes(out)
    return path
