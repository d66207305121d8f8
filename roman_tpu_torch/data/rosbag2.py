"""Pure-python ROS2 bag (rosbag2 sqlite3 storage) reading and writing
(host copy of roman_tpu/data/rosbag2.py).

Complements roman_tpu_torch.data.rosbag (ROS1): the reference's data layer
ingests both ROS1 and ROS2 recordings through robotdatapy (reference
roman/params/data_params.py:200-294). A rosbag2 recording is a directory
with ``metadata.yaml`` and one or more ``*.db3`` sqlite files holding
``topics`` and ``messages`` tables; message payloads are CDR-encoded
(little-endian, primitives aligned to their own size relative to the
start of the payload after the 4-byte encapsulation header; strings are
u32-length-prefixed and null-terminated).

Message set mirrors the ROS1 module. ROS2 field differences handled
here: ``std_msgs/msg/Header`` has no ``seq`` and uses
``builtin_interfaces/Time {sec int32, nanosec uint32}``; type names are
``pkg/msg/Name``.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_CDR_LE = b"\x00\x01\x00\x00"


# ---------------------------------------------------------------------------
# CDR (de)serialization
# ---------------------------------------------------------------------------

class _Cdr:
    """Little-endian CDR cursor; ``i`` counts from payload start (after
    the encapsulation header) so alignment is relative to it."""

    def __init__(self, buf: bytes):
        if len(buf) < 4 or buf[1] not in (0x01, 0x00):
            raise ValueError("bad CDR encapsulation header")
        if buf[1] != 0x01:
            raise ValueError("big-endian CDR not supported")
        self.buf = buf[4:]
        self.i = 0

    def _align(self, n: int):
        r = self.i % n
        if r:
            self.i += n - r

    def u8(self) -> int:
        v = self.buf[self.i]
        self.i += 1
        return v

    def i32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<i", self.buf, self.i)
        self.i += 4
        return v

    def u32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def f64(self) -> float:
        self._align(8)
        (v,) = struct.unpack_from("<d", self.buf, self.i)
        self.i += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        self._align(8)
        v = np.frombuffer(self.buf, "<f8", count=n, offset=self.i)
        self.i += 8 * n
        return np.asarray(v)

    def string(self) -> str:
        n = self.u32()  # length includes the null terminator
        s = self.buf[self.i:self.i + max(n - 1, 0)]
        self.i += n
        return s.decode("utf-8", "replace")

    def raw_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.i:self.i + n]
        self.i += n
        return b

    def time(self) -> float:
        return self.i32() + self.u32() * 1e-9

    def header(self) -> dict:
        return {"stamp": self.time(), "frame_id": self.string()}


class _CdrOut:
    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int):
        r = len(self.buf) % n
        if r:
            self.buf += b"\x00" * (n - r)

    def u8(self, v):
        self.buf += struct.pack("<B", int(v))

    def i32(self, v):
        self._align(4)
        self.buf += struct.pack("<i", int(v))

    def u32(self, v):
        self._align(4)
        self.buf += struct.pack("<I", int(v))

    def f64(self, v):
        self._align(8)
        self.buf += struct.pack("<d", float(v))

    def f64s(self, arr):
        self._align(8)
        self.buf += np.asarray(arr, "<f8").tobytes()

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.u32(len(b))
        self.buf += b

    def raw_seq(self, b: bytes):
        self.u32(len(b))
        self.buf += bytes(b)

    def time(self, t: float):
        sec = int(t)
        nsec = int(round((t - sec) * 1e9))
        if nsec >= 1_000_000_000:
            sec, nsec = sec + 1, nsec - 1_000_000_000
        self.i32(sec)
        self.u32(nsec)

    def header(self, h: dict):
        self.time(h.get("stamp", 0.0))
        self.string(h.get("frame_id", ""))

    def bytes(self) -> bytes:
        return _CDR_LE + bytes(self.buf)


def _de_pose(c: _Cdr) -> dict:
    return {"position": c.f64s(3), "orientation": c.f64s(4)}


def _ser_pose(o: _CdrOut, p: dict):
    o.f64s(np.asarray(p["position"], np.float64))
    o.f64s(np.asarray(p["orientation"], np.float64))


def _de_image(c: _Cdr) -> dict:
    h = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    is_bigendian = c.u8()
    step = c.u32()
    data = c.raw_seq()
    return {"header": h, "height": height, "width": width,
            "encoding": encoding, "is_bigendian": is_bigendian,
            "step": step, "data": data}


def _ser_image(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.u32(m["height"])
    o.u32(m["width"])
    o.string(m["encoding"])
    o.u8(m.get("is_bigendian", 0))
    o.u32(m["step"])
    o.raw_seq(m["data"])


def _de_compressed_image(c: _Cdr) -> dict:
    return {"header": c.header(), "format": c.string(), "data": c.raw_seq()}


def _ser_compressed_image(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.string(m["format"])
    o.raw_seq(m["data"])


def _de_camera_info(c: _Cdr) -> dict:
    h = c.header()
    height, width = c.u32(), c.u32()
    model = c.string()
    D = c.f64s(c.u32())
    K = c.f64s(9).reshape(3, 3)
    R = c.f64s(9).reshape(3, 3)
    P = c.f64s(12).reshape(3, 4)
    binning = (c.u32(), c.u32())
    roi = {"x_offset": c.u32(), "y_offset": c.u32(), "height": c.u32(),
           "width": c.u32(), "do_rectify": bool(c.u8())}
    return {"header": h, "height": height, "width": width,
            "distortion_model": model, "D": D, "K": K, "R": R, "P": P,
            "binning": binning, "roi": roi}


def _ser_camera_info(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.u32(m["height"])
    o.u32(m["width"])
    o.string(m.get("distortion_model", "plumb_bob"))
    D = np.asarray(m.get("D", np.zeros(5)), np.float64)
    o.u32(len(D))
    o.f64s(D)
    o.f64s(np.asarray(m["K"], np.float64).reshape(9))
    o.f64s(np.asarray(m.get("R", np.eye(3)), np.float64).reshape(9))
    P = m.get("P")
    if P is None:
        K = np.asarray(m["K"], np.float64).reshape(3, 3)
        P = np.hstack([K, np.zeros((3, 1))])
    o.f64s(np.asarray(P, np.float64).reshape(12))
    bx, by = m.get("binning", (0, 0))
    o.u32(bx)
    o.u32(by)
    roi = m.get("roi", {})
    o.u32(roi.get("x_offset", 0))
    o.u32(roi.get("y_offset", 0))
    o.u32(roi.get("height", 0))
    o.u32(roi.get("width", 0))
    o.u8(int(roi.get("do_rectify", False)))


def _de_odometry(c: _Cdr) -> dict:
    h = c.header()
    child = c.string()
    pose = _de_pose(c)
    pose_cov = c.f64s(36).reshape(6, 6)
    twist = {"linear": c.f64s(3), "angular": c.f64s(3)}
    twist_cov = c.f64s(36).reshape(6, 6)
    return {"header": h, "child_frame_id": child, "pose": pose,
            "pose_covariance": pose_cov, "twist": twist,
            "twist_covariance": twist_cov}


def _ser_odometry(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.string(m.get("child_frame_id", ""))
    _ser_pose(o, m["pose"])
    o.f64s(np.asarray(m.get("pose_covariance", np.zeros((6, 6)))).reshape(36))
    tw = m.get("twist", {"linear": np.zeros(3), "angular": np.zeros(3)})
    o.f64s(np.asarray(tw["linear"], np.float64))
    o.f64s(np.asarray(tw["angular"], np.float64))
    o.f64s(np.asarray(m.get("twist_covariance", np.zeros((6, 6)))).reshape(36))


def _de_pose_stamped(c: _Cdr) -> dict:
    return {"header": c.header(), "pose": _de_pose(c)}


def _ser_pose_stamped(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    _ser_pose(o, m["pose"])


def _de_pose_with_cov_stamped(c: _Cdr) -> dict:
    h = c.header()
    pose = _de_pose(c)
    cov = c.f64s(36).reshape(6, 6)
    return {"header": h, "pose": pose, "pose_covariance": cov}


def _ser_pose_with_cov_stamped(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    _ser_pose(o, m["pose"])
    o.f64s(np.asarray(m.get("pose_covariance", np.zeros((6, 6)))).reshape(36))


def _de_transform_stamped(c: _Cdr) -> dict:
    h = c.header()
    child = c.string()
    return {"header": h, "child_frame_id": child,
            "transform": {"translation": c.f64s(3), "rotation": c.f64s(4)}}


def _ser_transform_stamped(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.string(m.get("child_frame_id", ""))
    tr = m["transform"]
    o.f64s(np.asarray(tr["translation"], np.float64))
    o.f64s(np.asarray(tr["rotation"], np.float64))


def _de_tf_message(c: _Cdr) -> dict:
    n = c.u32()
    return {"transforms": [_de_transform_stamped(c) for _ in range(n)]}


def _ser_tf_message(o: _CdrOut, m: dict):
    o.u32(len(m["transforms"]))
    for tr in m["transforms"]:
        _ser_transform_stamped(o, tr)


def _de_pointcloud2(c: _Cdr) -> dict:
    h = c.header()
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        fields.append({"name": c.string(), "offset": c.u32(),
                       "datatype": c.u8(), "count": c.u32()})
    is_bigendian = c.u8()
    point_step = c.u32()
    row_step = c.u32()
    data = c.raw_seq()
    is_dense = c.u8()
    return {"header": h, "height": height, "width": width, "fields": fields,
            "is_bigendian": is_bigendian, "point_step": point_step,
            "row_step": row_step, "data": data, "is_dense": is_dense}


def _ser_pointcloud2(o: _CdrOut, m: dict):
    o.header(m.get("header", {}))
    o.u32(m["height"])
    o.u32(m["width"])
    o.u32(len(m["fields"]))
    for f in m["fields"]:
        o.string(f["name"])
        o.u32(f["offset"])
        o.u8(f["datatype"])
        o.u32(f.get("count", 1))
    o.u8(m.get("is_bigendian", 0))
    o.u32(m["point_step"])
    o.u32(m["row_step"])
    o.raw_seq(m["data"])
    o.u8(m.get("is_dense", 1))


_DESERIALIZERS = {
    "sensor_msgs/msg/Image": _de_image,
    "sensor_msgs/msg/CompressedImage": _de_compressed_image,
    "sensor_msgs/msg/CameraInfo": _de_camera_info,
    "nav_msgs/msg/Odometry": _de_odometry,
    "geometry_msgs/msg/PoseStamped": _de_pose_stamped,
    "geometry_msgs/msg/PoseWithCovarianceStamped": _de_pose_with_cov_stamped,
    "geometry_msgs/msg/TransformStamped": _de_transform_stamped,
    "tf2_msgs/msg/TFMessage": _de_tf_message,
    "sensor_msgs/msg/PointCloud2": _de_pointcloud2,
}

_SERIALIZERS = {
    "sensor_msgs/msg/Image": _ser_image,
    "sensor_msgs/msg/CompressedImage": _ser_compressed_image,
    "sensor_msgs/msg/CameraInfo": _ser_camera_info,
    "nav_msgs/msg/Odometry": _ser_odometry,
    "geometry_msgs/msg/PoseStamped": _ser_pose_stamped,
    "geometry_msgs/msg/PoseWithCovarianceStamped": _ser_pose_with_cov_stamped,
    "geometry_msgs/msg/TransformStamped": _ser_transform_stamped,
    "tf2_msgs/msg/TFMessage": _ser_tf_message,
    "sensor_msgs/msg/PointCloud2": _ser_pointcloud2,
}


def deserialize(msgtype: str, raw: bytes) -> dict:
    de = _DESERIALIZERS.get(msgtype)
    if de is None:
        raise ValueError(f"unsupported ROS2 message type {msgtype!r} "
                         f"(supported: {sorted(_DESERIALIZERS)})")
    return de(_Cdr(raw))


def serialize(msgtype: str, msg: dict) -> bytes:
    ser = _SERIALIZERS.get(msgtype)
    if ser is None:
        raise ValueError(f"unsupported ROS2 message type {msgtype!r}")
    out = _CdrOut()
    ser(out, msg)
    return out.bytes()


def ros1_type(msgtype: str) -> str:
    """'sensor_msgs/msg/Image' -> 'sensor_msgs/Image' (for shared
    downstream handling with the ROS1 module)."""
    parts = msgtype.split("/")
    return f"{parts[0]}/{parts[-1]}"


# ---------------------------------------------------------------------------
# sqlite storage
# ---------------------------------------------------------------------------

def _resolve_db3(path: str) -> List[str]:
    path = os.path.expanduser(path)
    if os.path.isdir(path):
        dbs = sorted(os.path.join(path, f) for f in os.listdir(path)
                     if f.endswith(".db3"))
        if not dbs:
            raise ValueError(f"{path}: no .db3 files (not a rosbag2 dir)")
        return dbs
    if path.endswith(".db3"):
        return [path]
    raise ValueError(f"{path}: not a rosbag2 directory or .db3 file")


def is_rosbag2(path: str) -> bool:
    path = os.path.expanduser(path)
    if path.endswith(".db3") and os.path.isfile(path):
        return True
    return os.path.isdir(path) and any(
        f.endswith(".db3") for f in os.listdir(path))


class Bag2Reader:
    """Reader over one rosbag2 directory (or a single .db3 file)."""

    def __init__(self, path: str):
        self.path = path
        self._dbs = _resolve_db3(path)
        self._topics: Dict[str, Tuple[str, int]] = {}
        for db in self._dbs:
            con = sqlite3.connect(db)
            try:
                rows = con.execute(
                    "SELECT t.name, t.type, COUNT(m.id) FROM topics t "
                    "LEFT JOIN messages m ON m.topic_id = t.id GROUP BY t.id"
                ).fetchall()
            finally:
                con.close()
            for name, typ, cnt in rows:
                prev = self._topics.get(name, (typ, 0))
                self._topics[name] = (typ, prev[1] + cnt)

    @property
    def topics(self) -> Dict[str, Tuple[str, int]]:
        return dict(self._topics)

    def read_messages(self, topics=None,
                      raw: bool = False) -> Iterator[Tuple[str, object, float]]:
        """Yield (topic, msg, t) in time order, STREAMING: each .db3 is
        scanned with ORDER BY timestamp and the per-file cursors are
        k-way merged, so peak memory is one row per file instead of the
        whole (possibly multi-GB) payload set."""
        import heapq

        if isinstance(topics, str):
            topics = [topics]
        want = None if topics is None else set(topics)
        cons = [sqlite3.connect(db) for db in self._dbs]
        try:
            cursors = [
                con.execute(
                    "SELECT m.timestamp, t.name, t.type, m.data "
                    "FROM messages m JOIN topics t ON m.topic_id = t.id "
                    "ORDER BY m.timestamp")
                for con in cons
            ]
            for ts, name, typ, data in heapq.merge(
                    *cursors, key=lambda r: r[0]):
                if want is not None and name not in want:
                    continue
                msg = bytes(data) if raw else deserialize(typ, bytes(data))
                yield name, msg, ts * 1e-9
        finally:
            for con in cons:
                con.close()


class Bag2Writer:
    """Writes a rosbag2 directory: <name>/<name>_0.db3 + metadata.yaml."""

    def __init__(self, path: str):
        self.dir = os.path.expanduser(path)
        os.makedirs(self.dir, exist_ok=True)
        base = os.path.basename(os.path.normpath(self.dir))
        self.db_path = os.path.join(self.dir, f"{base}_0.db3")
        self._con = sqlite3.connect(self.db_path)
        self._con.executescript(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL,"
            " type TEXT NOT NULL, serialization_format TEXT NOT NULL,"
            " offered_qos_profiles TEXT NOT NULL);"
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER"
            " NOT NULL, timestamp INTEGER NOT NULL, data BLOB NOT NULL);"
        )
        self._topic_ids: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}
        self._types: Dict[str, str] = {}
        self._tmin: Optional[int] = None
        self._tmax: Optional[int] = None
        self._closed = False

    def write(self, topic: str, msgtype: str, msg: dict, t: float):
        if topic not in self._topic_ids:
            tid = len(self._topic_ids) + 1
            self._topic_ids[topic] = tid
            self._types[topic] = msgtype
            self._con.execute(
                "INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')",
                (tid, topic, msgtype))
        ts = int(round(t * 1e9))
        self._con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)",
            (self._topic_ids[topic], ts, serialize(msgtype, msg)))
        self._counts[topic] = self._counts.get(topic, 0) + 1
        self._tmin = ts if self._tmin is None else min(self._tmin, ts)
        self._tmax = ts if self._tmax is None else max(self._tmax, ts)

    def close(self):
        if self._closed:
            return
        self._con.commit()
        self._con.close()
        total = sum(self._counts.values())
        t0 = self._tmin or 0
        dur = (self._tmax or 0) - t0
        entries = "\n".join(
            "    - topic_metadata:\n"
            f"        name: {name}\n"
            f"        type: {self._types[name]}\n"
            "        serialization_format: cdr\n"
            "        offered_qos_profiles: \"\"\n"
            f"      message_count: {cnt}"
            for name, cnt in self._counts.items())
        meta = (
            "rosbag2_bagfile_information:\n"
            "  version: 4\n"
            "  storage_identifier: sqlite3\n"
            "  relative_file_paths:\n"
            f"    - {os.path.basename(self.db_path)}\n"
            f"  duration:\n    nanoseconds: {dur}\n"
            f"  starting_time:\n    nanoseconds_since_epoch: {t0}\n"
            f"  message_count: {total}\n"
            "  topics_with_message_count:\n"
            f"{entries}\n"
            "  compression_format: \"\"\n"
            "  compression_mode: \"\"\n")
        with open(os.path.join(self.dir, "metadata.yaml"), "w") as f:
            f.write(meta)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
