"""Pure-python ROS1 bag (format 2.0) reading and writing (host copy of
roman_tpu/data/rosbag.py).

The reference ingests recorded robot data from ROS bags through
robotdatapy (reference roman/params/data_params.py:200-294,
README.md:122). The port needs no ROS installation: the bag
container format and the ROS1 message wire format are parsed directly
(spec: http://wiki.ros.org/Bags/Format/2.0 and the ROS msg serialization
rules: little-endian packed primitives, uint32-length-prefixed strings
and variable arrays, no padding).

Supported chunk compressions: ``none``, ``bz2`` (stdlib) and ``lz4``
(pure-python frame codec in roman_tpu_torch.data.lz4 — roslz4 writes standard
LZ4 frames; no lz4 wheel needed).

Message types handled (the set the reference pipeline consumes):

- ``sensor_msgs/Image`` (rgb8/bgr8/rgba8/bgra8/mono8/mono16/16UC1/32FC1)
- ``sensor_msgs/CompressedImage`` (png decoded with zlib and numpy by
  roman_tpu_torch.data.png; jpeg and other formats need OpenCV)
- ``sensor_msgs/CameraInfo``
- ``nav_msgs/Odometry``
- ``geometry_msgs/PoseStamped`` / ``PoseWithCovarianceStamped``
- ``geometry_msgs/TransformStamped`` / ``tf2_msgs/TFMessage``
- ``sensor_msgs/PointCloud2``

`BagWriter` emits spec-complete bags (bag header + chunks + connection,
index-data and chunk-info records) so external rosbag tools can read
them; it doubles as the test fixture generator and as an export path for
users converting other sources to bags.
"""

from __future__ import annotations

import bz2
import collections
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from roman_tpu_torch.data import png
from roman_tpu_torch.utils import require

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# record-level container I/O
# ---------------------------------------------------------------------------

def _pack_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i:i + n]
        i += n
        eq = entry.index(b"=")
        fields[entry[:eq]] = entry[eq + 1:]
    return fields


def _read_record(buf: bytes, pos: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, pos)
    header = _parse_header(buf[pos + 4:pos + 4 + hlen])
    pos += 4 + hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    data = buf[pos + 4:pos + 4 + dlen]
    return header, data, pos + 4 + dlen


def _time_to_u64(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _u64_to_time(b: bytes) -> float:
    secs, nsecs = struct.unpack("<II", b)
    return secs + nsecs * 1e-9


# ---------------------------------------------------------------------------
# ROS1 message wire format
# ---------------------------------------------------------------------------

class _Cur:
    """Little-endian cursor over a serialized ROS1 message."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u8(self) -> int:
        v = self.buf[self.i]
        self.i += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.i)
        self.i += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", count=n, offset=self.i)
        self.i += 8 * n
        return np.asarray(v)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i:self.i + n]
        self.i += n
        return s.decode("utf-8", "replace")

    def time(self) -> float:
        secs, nsecs = struct.unpack_from("<II", self.buf, self.i)
        self.i += 8
        return secs + nsecs * 1e-9

    def raw(self, n: int) -> bytes:
        b = self.buf[self.i:self.i + n]
        self.i += n
        return b

    def header(self) -> dict:
        return {"seq": self.u32(), "stamp": self.time(),
                "frame_id": self.string()}


class _Out:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", int(v)))

    def u32(self, v):
        self.parts.append(struct.pack("<I", int(v)))

    def f64(self, v):
        self.parts.append(struct.pack("<d", float(v)))

    def f64s(self, arr):
        self.parts.append(np.asarray(arr, "<f8").tobytes())

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def time(self, t: float):
        self.parts.append(_time_to_u64(t))

    def raw(self, b: bytes):
        self.parts.append(bytes(b))

    def header(self, h: dict):
        self.u32(h.get("seq", 0))
        self.time(h.get("stamp", 0.0))
        self.string(h.get("frame_id", ""))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def _de_pose(c: _Cur) -> dict:
    return {"position": c.f64s(3), "orientation": c.f64s(4)}  # xyz, xyzw


def _ser_pose(o: _Out, p: dict):
    o.f64s(np.asarray(p["position"], np.float64))
    o.f64s(np.asarray(p["orientation"], np.float64))


def _de_image(c: _Cur) -> dict:
    h = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    is_bigendian = c.u8()
    step = c.u32()
    data = c.raw(c.u32())
    return {"header": h, "height": height, "width": width,
            "encoding": encoding, "is_bigendian": is_bigendian,
            "step": step, "data": data}


def _ser_image(o: _Out, m: dict):
    o.header(m.get("header", {}))
    o.u32(m["height"])
    o.u32(m["width"])
    o.string(m["encoding"])
    o.u8(m.get("is_bigendian", 0))
    o.u32(m["step"])
    o.u32(len(m["data"]))
    o.raw(m["data"])


def _de_compressed_image(c: _Cur) -> dict:
    return {"header": c.header(), "format": c.string(),
            "data": c.raw(c.u32())}


def _ser_compressed_image(o: _Out, m: dict):
    o.header(m.get("header", {}))
    o.string(m["format"])
    o.u32(len(m["data"]))
    o.raw(m["data"])


def _de_camera_info(c: _Cur) -> dict:
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


def _ser_camera_info(o: _Out, m: dict):
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


def _de_odometry(c: _Cur) -> dict:
    h = c.header()
    child = c.string()
    pose = _de_pose(c)
    pose_cov = c.f64s(36).reshape(6, 6)
    twist = {"linear": c.f64s(3), "angular": c.f64s(3)}
    twist_cov = c.f64s(36).reshape(6, 6)
    return {"header": h, "child_frame_id": child, "pose": pose,
            "pose_covariance": pose_cov, "twist": twist,
            "twist_covariance": twist_cov}


def _ser_odometry(o: _Out, m: dict):
    o.header(m.get("header", {}))
    o.string(m.get("child_frame_id", ""))
    _ser_pose(o, m["pose"])
    o.f64s(np.asarray(m.get("pose_covariance", np.zeros((6, 6)))).reshape(36))
    tw = m.get("twist", {"linear": np.zeros(3), "angular": np.zeros(3)})
    o.f64s(np.asarray(tw["linear"], np.float64))
    o.f64s(np.asarray(tw["angular"], np.float64))
    o.f64s(np.asarray(m.get("twist_covariance", np.zeros((6, 6)))).reshape(36))


def _de_pose_stamped(c: _Cur) -> dict:
    return {"header": c.header(), "pose": _de_pose(c)}


def _ser_pose_stamped(o: _Out, m: dict):
    o.header(m.get("header", {}))
    _ser_pose(o, m["pose"])


def _de_pose_with_cov_stamped(c: _Cur) -> dict:
    h = c.header()
    pose = _de_pose(c)
    cov = c.f64s(36).reshape(6, 6)
    return {"header": h, "pose": pose, "pose_covariance": cov}


def _ser_pose_with_cov_stamped(o: _Out, m: dict):
    o.header(m.get("header", {}))
    _ser_pose(o, m["pose"])
    o.f64s(np.asarray(m.get("pose_covariance", np.zeros((6, 6)))).reshape(36))


def _de_transform_stamped(c: _Cur) -> dict:
    h = c.header()
    child = c.string()
    return {"header": h, "child_frame_id": child,
            "transform": {"translation": c.f64s(3), "rotation": c.f64s(4)}}


def _ser_transform_stamped(o: _Out, m: dict):
    o.header(m.get("header", {}))
    o.string(m.get("child_frame_id", ""))
    tr = m["transform"]
    o.f64s(np.asarray(tr["translation"], np.float64))
    o.f64s(np.asarray(tr["rotation"], np.float64))


def _de_tf_message(c: _Cur) -> dict:
    n = c.u32()
    return {"transforms": [_de_transform_stamped(c) for _ in range(n)]}


def _ser_tf_message(o: _Out, m: dict):
    o.u32(len(m["transforms"]))
    for tr in m["transforms"]:
        _ser_transform_stamped(o, tr)


_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
              7: "f4", 8: "f8"}
_PF_CODES = {v: k for k, v in _PF_DTYPES.items()}


def _de_pointcloud2(c: _Cur) -> dict:
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
    data = c.raw(c.u32())
    is_dense = c.u8()
    return {"header": h, "height": height, "width": width, "fields": fields,
            "is_bigendian": is_bigendian, "point_step": point_step,
            "row_step": row_step, "data": data, "is_dense": is_dense}


def _ser_pointcloud2(o: _Out, m: dict):
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
    o.u32(len(m["data"]))
    o.raw(m["data"])
    o.u8(m.get("is_dense", 1))


_DESERIALIZERS = {
    "sensor_msgs/Image": _de_image,
    "sensor_msgs/CompressedImage": _de_compressed_image,
    "sensor_msgs/CameraInfo": _de_camera_info,
    "nav_msgs/Odometry": _de_odometry,
    "geometry_msgs/PoseStamped": _de_pose_stamped,
    "geometry_msgs/PoseWithCovarianceStamped": _de_pose_with_cov_stamped,
    "geometry_msgs/TransformStamped": _de_transform_stamped,
    "tf2_msgs/TFMessage": _de_tf_message,
    "tf/tfMessage": _de_tf_message,
    "sensor_msgs/PointCloud2": _de_pointcloud2,
}

_SERIALIZERS = {
    "sensor_msgs/Image": _ser_image,
    "sensor_msgs/CompressedImage": _ser_compressed_image,
    "sensor_msgs/CameraInfo": _ser_camera_info,
    "nav_msgs/Odometry": _ser_odometry,
    "geometry_msgs/PoseStamped": _ser_pose_stamped,
    "geometry_msgs/PoseWithCovarianceStamped": _ser_pose_with_cov_stamped,
    "geometry_msgs/TransformStamped": _ser_transform_stamped,
    "tf2_msgs/TFMessage": _ser_tf_message,
    "sensor_msgs/PointCloud2": _ser_pointcloud2,
}

# standard md5sums for the supported types (fixed constants in ROS1;
# carried so bags we write are accepted by stock rosbag tooling)
_MD5 = {
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
    "sensor_msgs/CompressedImage": "8f7a12909da2c9d3332d540a0977563f",
    "sensor_msgs/CameraInfo": "c9a58c1b0b154e0e6da7578cb991d214",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    "geometry_msgs/PoseStamped": "d3812c3cbc69362b77dc0b19b345f8f5",
    "geometry_msgs/PoseWithCovarianceStamped": "953b798c0f514ff060a53a3498ce6246",
    "geometry_msgs/TransformStamped": "b5764a33bfeb3588febc2682852579b0",
    "tf2_msgs/TFMessage": "94810edda583a504dfda3829e70d7eec",
    "tf/tfMessage": "94810edda583a504dfda3829e70d7eec",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
}


def deserialize(msgtype: str, raw: bytes) -> dict:
    de = _DESERIALIZERS.get(msgtype)
    if de is None:
        raise ValueError(f"unsupported message type {msgtype!r} "
                         f"(supported: {sorted(_DESERIALIZERS)})")
    return de(_Cur(raw))


def serialize(msgtype: str, msg: dict) -> bytes:
    ser = _SERIALIZERS.get(msgtype)
    if ser is None:
        raise ValueError(f"unsupported message type {msgtype!r}")
    out = _Out()
    ser(out, msg)
    return out.bytes()


# ---------------------------------------------------------------------------
# image <-> array conversion
# ---------------------------------------------------------------------------

def image_to_array(msg: dict) -> np.ndarray:
    """sensor_msgs/Image payload -> numpy array (RGB order for color)."""
    enc = msg["encoding"].lower()
    h, w = msg["height"], msg["width"]
    buf = msg["data"]
    order = ">" if msg.get("is_bigendian") else "<"
    if enc in ("rgb8", "bgr8"):
        arr = np.frombuffer(buf, np.uint8).reshape(h, msg["step"])[:, :w * 3]
        arr = arr.reshape(h, w, 3)
        return arr[..., ::-1] if enc == "bgr8" else arr
    if enc in ("rgba8", "bgra8"):
        arr = np.frombuffer(buf, np.uint8).reshape(h, msg["step"])[:, :w * 4]
        arr = arr.reshape(h, w, 4)[..., :3]
        return arr[..., ::-1] if enc == "bgra8" else arr
    if enc == "mono8" or enc == "8uc1":
        return np.frombuffer(buf, np.uint8).reshape(h, msg["step"])[:, :w]
    if enc in ("mono16", "16uc1"):
        arr = np.frombuffer(buf, order + "u2").reshape(h, msg["step"] // 2)
        return arr[:, :w]
    if enc == "32fc1":
        arr = np.frombuffer(buf, order + "f4").reshape(h, msg["step"] // 4)
        return arr[:, :w]
    raise ValueError(f"unsupported image encoding {msg['encoding']!r}")


def array_to_image(arr: np.ndarray, encoding: Optional[str] = None,
                   stamp: float = 0.0, frame_id: str = "") -> dict:
    """numpy array -> sensor_msgs/Image payload dict."""
    arr = np.ascontiguousarray(arr)
    if encoding is None:
        if arr.ndim == 3 and arr.shape[2] == 3 and arr.dtype == np.uint8:
            encoding = "rgb8"
        elif arr.ndim == 2 and arr.dtype == np.uint8:
            encoding = "mono8"
        elif arr.ndim == 2 and arr.dtype == np.uint16:
            encoding = "16UC1"
        elif arr.ndim == 2 and arr.dtype == np.float32:
            encoding = "32FC1"
        else:
            raise ValueError(f"cannot infer encoding for {arr.dtype}/{arr.shape}")
    h, w = arr.shape[:2]
    return {"header": {"stamp": stamp, "frame_id": frame_id},
            "height": h, "width": w, "encoding": encoding,
            "is_bigendian": 0, "step": arr.strides[0],
            "data": arr.tobytes()}


def pointcloud2_to_xyz(msg: dict) -> np.ndarray:
    """sensor_msgs/PointCloud2 -> (N, 3) float32 xyz (NaN rows dropped)."""
    names = {f["name"]: f for f in msg["fields"]}
    if not all(k in names for k in ("x", "y", "z")):
        raise ValueError("PointCloud2 without x/y/z fields")
    step = msg["point_step"]
    height = msg.get("height", 1) or 1
    width = msg.get("width", 0)
    row_step = msg.get("row_step", 0)
    buf = np.frombuffer(msg["data"], np.uint8)
    if height > 1 and row_step and row_step != width * step:
        # organized cloud with per-row padding: slice each row's points
        # (treating the payload as contiguous would read padding bytes as
        # coordinates from row 2 on)
        rows = buf[: height * row_step].reshape(height, row_step)
        raw = rows[:, : width * step].reshape(height * width, step)
    else:
        n = len(buf) // step
        raw = buf[: n * step].reshape(n, step)
    bo = ">" if msg.get("is_bigendian") else "<"
    cols = []
    for k in ("x", "y", "z"):
        f = names[k]
        dt = np.dtype(bo + _PF_DTYPES[f["datatype"]])
        col = raw[:, f["offset"]:f["offset"] + dt.itemsize].copy().view(dt)[:, 0]
        cols.append(col.astype(np.float32))
    xyz = np.stack(cols, axis=1)
    return xyz[np.all(np.isfinite(xyz), axis=1)]


def xyz_to_pointcloud2(xyz: np.ndarray, stamp: float = 0.0,
                       frame_id: str = "") -> dict:
    xyz = np.ascontiguousarray(xyz, np.float32)
    fields = [{"name": k, "offset": 4 * i, "datatype": _PF_CODES["f4"],
               "count": 1} for i, k in enumerate("xyz")]
    return {"header": {"stamp": stamp, "frame_id": frame_id},
            "height": 1, "width": len(xyz), "fields": fields,
            "is_bigendian": 0, "point_step": 12, "row_step": 12 * len(xyz),
            "data": xyz.tobytes(), "is_dense": 1}


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class BagReader:
    """Indexed bag reader: one scan builds a per-message (time, conn,
    chunk, offset) index; message payloads live in the memory-mapped
    file and chunks are decompressed on demand (small LRU), so peak RAM
    is ~one decompressed chunk instead of the whole decompressed bag —
    multi-GB recorded bags (params/kimera_multi_data) stream instead of
    slurping. ``topics`` maps topic -> (msgtype, message count)."""

    _CHUNK_CACHE = 4  # decompressed chunks kept (bag chunks are ~1 MB)

    def __init__(self, path: str):
        import mmap

        self.path = os.path.expanduser(path)
        self._file = open(self.path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file
            self._buf = b""
        if not self._buf[:len(MAGIC)] == MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag "
                             f"(magic {bytes(self._buf[:13])!r})")
        self._connections: Dict[int, dict] = {}
        # chunk table: (compression, data_start, data_end) file ranges
        self._chunks: List[Tuple[str, int, int]] = []
        # message index: (t, conn, chunk_id, offset). chunk_id -1 =
        # top-level record; offset is then the absolute record position
        self._index: List[Tuple[float, int, int, int]] = []
        self._chunk_lru: "collections.OrderedDict[int, bytes]" = (
            collections.OrderedDict())
        self._scan()

    def _decompress(self, comp: str, data: bytes) -> bytes:
        if comp == "none":
            return data
        if comp == "bz2":
            return bz2.decompress(data)
        if comp == "lz4":
            # roslz4 writes standard LZ4 frames; decoded by the
            # pure-python codec (no lz4 wheel needed)
            from roman_tpu_torch.data import lz4

            return lz4.decompress_frame(data)
        raise ValueError(f"unknown chunk compression {comp!r}")

    def _scan(self):
        buf = self._buf
        pos = len(MAGIC)
        end = len(buf)
        while pos < end:
            rec_pos = pos
            header, data, pos = _read_record(buf, pos)
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CHUNK:
                comp = header.get(b"compression", b"none").decode()
                cid = len(self._chunks)
                self._chunks.append((comp, pos - len(data), pos))
                inner = self._decompress(comp, data)
                ipos = 0
                while ipos < len(inner):
                    inner_pos = ipos
                    ih, idata, ipos = _read_record(inner, ipos)
                    self._record(ih, idata, cid, inner_pos)
            else:
                self._record(header, data, -1, rec_pos)

    def _record(self, header: Dict[bytes, bytes], data: bytes,
                chunk_id: int, offset: int):
        op = header.get(b"op", b"\x00")[0]
        if op == _OP_CONNECTION:
            conn = struct.unpack("<I", header[b"conn"])[0]
            fields = _parse_header(data)
            self._connections[conn] = {
                "topic": fields.get(b"topic", header.get(b"topic", b"")).decode(),
                "type": fields.get(b"type", b"").decode(),
                "md5sum": fields.get(b"md5sum", b"").decode(),
            }
        elif op == _OP_MSG:
            conn = struct.unpack("<I", header[b"conn"])[0]
            t = _u64_to_time(header[b"time"])
            self._index.append((t, conn, chunk_id, offset))

    def _chunk_bytes(self, cid: int) -> bytes:
        if cid in self._chunk_lru:
            self._chunk_lru.move_to_end(cid)
            return self._chunk_lru[cid]
        comp, start, end = self._chunks[cid]
        inner = self._decompress(comp, self._buf[start:end])
        self._chunk_lru[cid] = inner
        while len(self._chunk_lru) > self._CHUNK_CACHE:
            self._chunk_lru.popitem(last=False)
        return inner

    def _payload(self, chunk_id: int, offset: int) -> bytes:
        buf = self._buf if chunk_id < 0 else self._chunk_bytes(chunk_id)
        _, data, _ = _read_record(buf, offset)
        return data

    @property
    def topics(self) -> Dict[str, Tuple[str, int]]:
        counts: Dict[int, int] = {}
        for _, conn, _, _ in self._index:
            counts[conn] = counts.get(conn, 0) + 1
        return {c["topic"]: (c["type"], counts.get(cid, 0))
                for cid, c in self._connections.items()}

    def read_messages(self, topics=None,
                      raw: bool = False) -> Iterator[Tuple[str, object, float]]:
        """Yield (topic, msg, t) in time order; msg is a dict unless
        ``raw`` (then the serialized bytes)."""
        if isinstance(topics, str):
            topics = [topics]
        want = None if topics is None else set(topics)
        for t, conn, cid, off in sorted(self._index, key=lambda m: m[0]):
            info = self._connections.get(conn)
            if info is None or (want is not None and info["topic"] not in want):
                continue
            data = self._payload(cid, off)
            msg = data if raw else deserialize(info["type"], data)
            yield info["topic"], msg, t


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class BagWriter:
    """Writes spec-complete v2.0 bags: padded bag-header record, one chunk
    per ``chunk_messages`` messages, connection records repeated in the
    index section, index-data per (chunk, connection), chunk-info records.
    """

    def __init__(self, path: str, compression: str = "none",
                 chunk_messages: int = 256):
        if compression not in ("none", "bz2", "lz4"):
            raise ValueError("compression must be 'none', 'bz2' or 'lz4'")
        self.path = os.path.expanduser(path)
        self.compression = compression
        self.chunk_messages = chunk_messages
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        # placeholder bag header (rewritten on close); spec pads the record
        # to 4096 bytes so the final header fits in place
        self._bag_header_pos = self._f.tell()
        self._write_bag_header(0, 0, 0)
        self._conn_ids: Dict[str, int] = {}
        self._conn_records: List[Tuple[Dict[bytes, bytes], bytes]] = []
        self._pending: List[Tuple[float, int, bytes]] = []
        self._chunk_infos: List[dict] = []
        self._closed = False

    # -- records ----------------------------------------------------------
    def _write_record(self, fields: Dict[bytes, bytes], data: bytes):
        header = _pack_header(fields)
        self._f.write(struct.pack("<I", len(header)) + header)
        self._f.write(struct.pack("<I", len(data)) + data)

    def _write_bag_header(self, index_pos: int, conn_count: int,
                          chunk_count: int):
        fields = {
            b"op": bytes([_OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", index_pos),
            b"conn_count": struct.pack("<I", conn_count),
            b"chunk_count": struct.pack("<I", chunk_count),
        }
        header = _pack_header(fields)
        pad = 4096 - 8 - len(header)
        self._f.write(struct.pack("<I", len(header)) + header)
        self._f.write(struct.pack("<I", pad) + b" " * pad)

    def _connection(self, topic: str, msgtype: str) -> int:
        if topic in self._conn_ids:
            return self._conn_ids[topic]
        cid = len(self._conn_ids)
        self._conn_ids[topic] = cid
        conn_header = {b"op": bytes([_OP_CONNECTION]),
                       b"conn": struct.pack("<I", cid),
                       b"topic": topic.encode()}
        conn_data = _pack_header({
            b"topic": topic.encode(),
            b"type": msgtype.encode(),
            b"md5sum": _MD5.get(msgtype, "*").encode(),
            b"message_definition": f"# {msgtype}\n".encode(),
        })
        self._conn_records.append((conn_header, conn_data))
        return cid

    # -- public API --------------------------------------------------------
    def write(self, topic: str, msgtype: str, msg: dict, t: float):
        cid = self._connection(topic, msgtype)
        self._pending.append((t, cid, serialize(msgtype, msg)))
        if len(self._pending) >= self.chunk_messages:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._pending:
            return
        chunk_pos = self._f.tell()
        inner = bytearray()
        conn_counts: Dict[int, int] = {}
        index: Dict[int, List[Tuple[float, int]]] = {}
        # connections must be discoverable inside the chunk too
        for ch, cd in self._conn_records:
            header = _pack_header(ch)
            inner += struct.pack("<I", len(header)) + header
            inner += struct.pack("<I", len(cd)) + cd
        for t, cid, raw in self._pending:
            header = _pack_header({b"op": bytes([_OP_MSG]),
                                   b"conn": struct.pack("<I", cid),
                                   b"time": _time_to_u64(t)})
            index.setdefault(cid, []).append((t, len(inner)))
            conn_counts[cid] = conn_counts.get(cid, 0) + 1
            inner += struct.pack("<I", len(header)) + header
            inner += struct.pack("<I", len(raw)) + raw
        payload = bytes(inner)
        if self.compression == "bz2":
            comp = bz2.compress(payload)
        elif self.compression == "lz4":
            from roman_tpu_torch.data import lz4

            comp = lz4.compress_frame(payload)
        else:
            comp = payload
        self._write_record({b"op": bytes([_OP_CHUNK]),
                            b"compression": self.compression.encode(),
                            b"size": struct.pack("<I", len(payload))}, comp)
        # per-connection index-data records follow the chunk
        for cid, entries in index.items():
            data = b"".join(_time_to_u64(t) + struct.pack("<I", off)
                            for t, off in entries)
            self._write_record({b"op": bytes([_OP_INDEX]),
                                b"ver": struct.pack("<I", 1),
                                b"conn": struct.pack("<I", cid),
                                b"count": struct.pack("<I", len(entries))},
                               data)
        times = [t for t, _, _ in self._pending]
        self._chunk_infos.append({
            "pos": chunk_pos, "start": min(times), "end": max(times),
            "counts": conn_counts,
        })
        self._pending = []

    def close(self):
        if self._closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        for ch, cd in self._conn_records:
            self._write_record(ch, cd)
        for info in self._chunk_infos:
            data = b"".join(struct.pack("<II", cid, n)
                            for cid, n in info["counts"].items())
            self._write_record({
                b"op": bytes([_OP_CHUNK_INFO]),
                b"ver": struct.pack("<I", 1),
                b"chunk_pos": struct.pack("<Q", info["pos"]),
                b"start_time": _time_to_u64(info["start"]),
                b"end_time": _time_to_u64(info["end"]),
                b"count": struct.pack("<I", len(info["counts"])),
            }, data)
        self._f.seek(self._bag_header_pos)
        self._write_bag_header(index_pos, len(self._conn_ids),
                               len(self._chunk_infos))
        self._f.seek(0, 2)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# high-level extraction (the surfaces data_params/demo consume)
# ---------------------------------------------------------------------------

_READER_CACHE: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_READER_CACHE_SIZE = 2


def open_reader(path: str):
    """BagReader (ROS1 .bag) or Bag2Reader (rosbag2 dir / .db3), sniffed
    from the path — the data layer is format-agnostic above this point.

    Parsed readers are cached by (realpath, mtime, size): loading a run
    reads the same camera bag for color frames, the depth topic, and
    camera_info back to back, and re-scanning the chunk index each time
    tripled ingestion I/O."""
    from roman_tpu_torch.data import rosbag2

    real = os.path.realpath(os.path.expanduser(path))
    try:
        st = os.stat(real)
        key = (real, st.st_mtime_ns, st.st_size)
    except OSError:
        key = (real, 0, 0)
    if key in _READER_CACHE:
        _READER_CACHE.move_to_end(key)
        return _READER_CACHE[key]
    reader = (rosbag2.Bag2Reader(path) if rosbag2.is_rosbag2(path)
              else BagReader(path))
    _READER_CACHE[key] = reader
    while len(_READER_CACHE) > _READER_CACHE_SIZE:
        _READER_CACHE.popitem(last=False)
    return reader


def _norm_type(msgtype: str) -> str:
    """'pkg/msg/Name' (ROS2) -> 'pkg/Name' so downstream handling is
    shared between the two formats."""
    return msgtype.replace("/msg/", "/")


def _decode_any_image(msgtype: str, msg: dict) -> np.ndarray:
    if msgtype == "sensor_msgs/Image":
        return image_to_array(msg)
    if msgtype == "sensor_msgs/CompressedImage":
        data = bytes(msg["data"])
        if data.startswith(png.SIGNATURE):
            # as cv2.imdecode(IMREAD_UNCHANGED) and a BGR(A) -> RGB flip:
            # colour keeps three channels, gray with alpha becomes RGB
            arr = png.decode_png(data)
            if arr.ndim == 3:
                arr = png.to_color(arr) if arr.shape[2] == 2 else arr[..., :3]
            return arr
        cv = require("cv2", f"decoding a {msg.get('format', '')!r} CompressedImage")
        arr = cv.imdecode(np.frombuffer(data, np.uint8), cv.IMREAD_UNCHANGED)
        if arr is None:
            raise ValueError("failed to decode CompressedImage payload")
        if arr.ndim == 3 and arr.shape[2] >= 3:
            arr = arr[..., 2::-1]  # BGR(A) -> RGB
        return arr
    raise ValueError(f"{msgtype} is not an image type")


def read_images(path: str, topic: str) -> Tuple[np.ndarray, np.ndarray]:
    """(times, images) for an Image/CompressedImage topic; header stamps
    preferred over bag receive times."""
    reader = open_reader(path)
    info = reader.topics.get(topic)
    if info is None:
        raise KeyError(f"topic {topic!r} not in bag (have {sorted(reader.topics)})")
    msgtype = _norm_type(info[0])
    times, imgs = [], []
    for _, msg, t in reader.read_messages(topic):
        stamp = msg.get("header", {}).get("stamp", 0.0) or t
        times.append(stamp)
        imgs.append(_decode_any_image(msgtype, msg))
    return np.asarray(times), np.stack(imgs)


def read_poses(path: str, topic: str,
               parent_frame: Optional[str] = None,
               child_frame: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(times, (T, 4, 4) poses) from Odometry / PoseStamped /
    PoseWithCovarianceStamped / TransformStamped / TFMessage topics.

    TF topics carry transforms for MANY (parent, child) frame pairs;
    pass parent_frame/child_frame to select one. With neither given, the
    most frequent pair is used (and a mix of pairs would otherwise
    interleave unrelated trajectories)."""
    from roman_tpu_torch.ops import se3_np

    reader = open_reader(path)
    info = reader.topics.get(topic)
    if info is None:
        raise KeyError(f"topic {topic!r} not in bag (have {sorted(reader.topics)})")
    msgtype = _norm_type(info[0])
    times, xyz, quat = [], [], []

    def add(stamp, p, q):
        times.append(stamp)
        xyz.append(np.asarray(p, np.float64))
        quat.append(np.asarray(q, np.float64))

    if msgtype in ("tf2_msgs/TFMessage", "tf/tfMessage"):
        per_pair: Dict[Tuple[str, str], list] = {}
        for _, msg, t in reader.read_messages(topic):
            for tr in msg["transforms"]:
                pair = (tr["header"].get("frame_id", ""),
                        tr.get("child_frame_id", ""))
                per_pair.setdefault(pair, []).append(
                    (tr["header"].get("stamp", 0.0) or t,
                     tr["transform"]["translation"],
                     tr["transform"]["rotation"]))
        if not per_pair:
            raise KeyError(f"no transforms on {topic!r}")
        if parent_frame is not None or child_frame is not None:
            matches = [p for p in per_pair
                       if (parent_frame is None or p[0] == parent_frame)
                       and (child_frame is None or p[1] == child_frame)]
            if not matches:
                raise KeyError(
                    f"no ({parent_frame!r}, {child_frame!r}) transforms on "
                    f"{topic!r} (have {sorted(per_pair)})")
            chosen = matches[0]
        else:
            chosen = max(per_pair, key=lambda p: len(per_pair[p]))
        for stamp, p, q in per_pair[chosen]:
            add(stamp, p, q)
        order = np.argsort(times)
        T = se3_np.xyz_quat_to_T(np.asarray(xyz)[order],
                                 np.asarray(quat)[order])
        return np.asarray(times)[order], T

    for _, msg, t in reader.read_messages(topic):
        stamp = msg.get("header", {}).get("stamp", 0.0) or t
        if msgtype == "geometry_msgs/TransformStamped":
            add(stamp, msg["transform"]["translation"],
                msg["transform"]["rotation"])
        else:  # Odometry / PoseStamped / PoseWithCovarianceStamped
            add(stamp, msg["pose"]["position"], msg["pose"]["orientation"])
    order = np.argsort(times)
    T = se3_np.xyz_quat_to_T(np.asarray(xyz)[order], np.asarray(quat)[order])
    return np.asarray(times)[order], T


def read_camera_info(path: str, topic: str) -> dict:
    """First CameraInfo message on the topic."""
    reader = open_reader(path)
    for _, msg, _ in reader.read_messages(topic):
        return msg
    raise KeyError(f"no CameraInfo on {topic!r}")


def read_pointclouds(path: str, topic: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(times, list of (N_i, 3) xyz arrays) from a PointCloud2 topic."""
    reader = open_reader(path)
    times, clouds = [], []
    for _, msg, t in reader.read_messages(topic):
        times.append(msg.get("header", {}).get("stamp", 0.0) or t)
        clouds.append(pointcloud2_to_xyz(msg))
    return np.asarray(times), clouds


def read_static_transform(path: str, parent: str, child: str,
                          include_non_static: bool = False) -> np.ndarray:
    """(4, 4) static transform parent->child from /tf_static (or /tf)
    messages — the reference pulls sensor extrinsics from bag TF via
    robotdatapy's any_static_tf_from_bag (data_params.py:39-57,
    align_pointcloud.py:43-57). Like robotdatapy, the lookup CHAINS
    through the TF tree: if no direct (parent, child) edge exists, the
    shortest path of static edges is composed (edges may be traversed
    against their published direction, inverting).

    /tf_static edges ALWAYS take priority, both per edge (first-seen
    dedup ordered static-first, so a dynamic /tf republish of the same
    frame pair — e.g. an identity published before calibration loads —
    cannot shadow the latched static value) and per PATH (the search
    minimizes dynamic-edge count before hop count, so a 1-hop /tf edge
    cannot shadow a multi-hop /tf_static chain). /tf edges — each at
    its first published value, for extrinsics that are 'theoretically
    static' — are admitted when include_non_static is set, or as a
    fallback when the static graph alone does not connect the two
    frames (so a bag carrying its extrinsics on /tf resolves whether or
    not an unrelated /tf_static topic exists). High-rate /tf scans stop
    as soon as parent and child are connected."""
    from roman_tpu_torch.ops import se3_np

    reader = open_reader(path)
    src, dst = parent.lstrip("/"), child.lstrip("/")
    if src == dst:
        return np.eye(4)
    # edge map (parent, child) -> first-seen T, frames normalized;
    # /tf_static is scanned fully first so its edges always win the
    # first-seen dedup against /tf republishes of the same pair.
    edges: Dict[Tuple[str, str], np.ndarray] = {}
    adj: Dict[str, list] = {}
    uf: Dict[str, str] = {}

    def find(x: str) -> str:
        uf.setdefault(x, x)
        while uf[x] != x:
            uf[x] = uf[uf[x]]
            x = uf[x]
        return x

    static_pairs: set = set()

    def scan(topic: str, early_exit: bool) -> None:
        static = topic == "/tf_static"
        for _, msg, _ in reader.read_messages([topic]):
            for tr in msg["transforms"]:
                a = tr["header"]["frame_id"].lstrip("/")
                b = tr["child_frame_id"].lstrip("/")
                if (a, b) in edges:
                    continue
                edges[(a, b)] = se3_np.xyz_quat_to_T(
                    np.array(tr["transform"]["translation"], np.float64),
                    np.array(tr["transform"]["rotation"], np.float64))
                if static:
                    static_pairs.add((a, b))
                adj.setdefault(a, []).append(b)
                adj.setdefault(b, []).append(a)
                uf[find(a)] = find(b)
            # a 100-400 Hz /tf stream over a long session is hundreds of
            # thousands of CDR decodes — stop once a path exists (any
            # static path is exact; the search below prefers static
            # edges over anything seen from /tf, so reading further /tf
            # messages could not improve the chosen path)
            if early_exit and find(src) == find(dst):
                return

    have_static = "/tf_static" in reader.topics
    have_tf = "/tf" in reader.topics
    if not have_static and not have_tf:
        raise KeyError(f"no /tf_static or /tf in bag (have "
                       f"{sorted(reader.topics)})")
    if have_static:
        scan("/tf_static", early_exit=False)  # latched + tiny: read all
    connected = find(src) == find(dst)
    if have_tf and (include_non_static or not connected):
        scan("/tf", early_exit=True)
    # shortest path by (dynamic-edge count, hop count): /tf edges are
    # only used where no static chain connects the components, so a
    # bogus 1-hop /tf edge (identity published before calibration
    # loads) can never shadow a multi-hop /tf_static chain
    import heapq

    def edge_static(a: str, b: str) -> bool:
        return (a, b) in static_pairs or (b, a) in static_pairs

    INF = (1 << 30, 1 << 30)
    best: Dict[str, Tuple[int, int]] = {src: (0, 0)}
    prev: Dict[str, str] = {src: src}
    heap = [(0, 0, src)]
    while heap:
        nd, nh, cur = heapq.heappop(heap)
        if (nd, nh) > best.get(cur, INF):
            continue
        if cur == dst:
            break
        for nxt in adj.get(cur, []):
            cost = (nd + (0 if edge_static(cur, nxt) else 1), nh + 1)
            if cost < best.get(nxt, INF):
                best[nxt] = cost
                prev[nxt] = cur
                heapq.heappush(heap, cost + (nxt,))
    if dst not in prev:
        raise KeyError(f"transform {parent}->{child} not found in bag TF "
                       f"(frames: {sorted(adj)})")
    path_frames = [dst]
    while path_frames[-1] != src:
        path_frames.append(prev[path_frames[-1]])
    path_frames.reverse()
    T = np.eye(4)
    for a, b in zip(path_frames[:-1], path_frames[1:]):
        step = (edges[(a, b)] if (a, b) in edges
                else np.linalg.inv(edges[(b, a)]))
        T = T @ step
    return T
