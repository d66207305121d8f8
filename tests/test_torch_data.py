"""The port's data layer held against roman_tpu's on the CPU.

The same seeded inputs go through roman_tpu.data / roman_tpu.params and
their copies in roman_tpu_torch: ROS1 bags written by either package and
read by the other (every message type, bz2 and lz4 chunks), the lz4
codec, rosbag2 and its CDR alignment, ImgData from npz, dir, zip and bag,
PoseData and CameraParams from bags, the static-first TF lookup, every
params/*/data.yaml, and the PNG decoder that stands in for cv2.imdecode.
"""

import dataclasses
import os
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from roman_tpu.data import lz4 as j_lz4
from roman_tpu.data import rosbag as j_rb
from roman_tpu.data import rosbag2 as j_rb2
from roman_tpu.data.camera import CameraParams as JCameraParams
from roman_tpu.data.img_data import ImgData as JImgData
from roman_tpu.data.pose_data import PoseData as JPoseData
from roman_tpu.ops import se3_np as j_se3
from roman_tpu.params import data_params as j_dp
from roman_tpu_torch.data import lz4 as t_lz4
from roman_tpu_torch.data import png
from roman_tpu_torch.data import rosbag as t_rb
from roman_tpu_torch.data import rosbag2 as t_rb2
from roman_tpu_torch.data.camera import CameraParams as TCameraParams
from roman_tpu_torch.data.img_data import ImgData as TImgData
from roman_tpu_torch.data.pose_data import PoseData as TPoseData
from roman_tpu_torch.params import data_params as t_dp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"roman_tpu": j_rb, "port": t_rb}


def assert_same(a, b, path="msg"):
    """Recursive equality of decoded messages (dicts, lists, arrays)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


def tf_msg(parent, child, T, stamp=0.0):
    t, q = j_se3.T_to_xyz_quat(T)
    return {"transforms": [{
        "header": {"stamp": stamp, "frame_id": parent},
        "child_frame_id": child,
        "transform": {"translation": t, "rotation": q}}]}


def every_message(seed=0):
    """(topic, msgtype, msg, t) of every message type rosbag.py handles."""
    rng = np.random.default_rng(seed)
    K = np.array([[25.0, 0, 16], [0, 25.0, 12], [0, 0, 1]])
    pose = {"position": rng.normal(size=3), "orientation": np.array([0, 0, 0.6, 0.8])}
    out = []
    for k in range(3):
        t = 100.0 + 0.25 * k
        hdr = {"stamp": t, "frame_id": "cam"}
        out += [
            ("/rgb", "sensor_msgs/Image", j_rb.array_to_image(
                rng.integers(0, 255, (6, 8, 3), dtype=np.uint8), stamp=t, frame_id="cam"), t),
            ("/mono16", "sensor_msgs/Image", j_rb.array_to_image(
                rng.integers(0, 65535, (6, 8), dtype=np.uint16), stamp=t), t),
            ("/depth32", "sensor_msgs/Image", j_rb.array_to_image(
                rng.uniform(0.5, 4, (6, 8)).astype(np.float32), stamp=t), t),
            ("/png", "sensor_msgs/CompressedImage", {
                "header": hdr, "format": "png",
                "data": png.encode_png(rng.integers(0, 255, (6, 8, 3), dtype=np.uint8))}, t),
            ("/odom", "nav_msgs/Odometry", {
                "header": {"stamp": t, "frame_id": "odom"}, "child_frame_id": "base",
                "pose": {"position": rng.normal(size=3),
                         "orientation": np.array([0, 0, 0, 1.0])}}, t),
            ("/pose", "geometry_msgs/PoseStamped", {"header": hdr, "pose": pose}, t),
            ("/posecov", "geometry_msgs/PoseWithCovarianceStamped",
             {"header": hdr, "pose": pose}, t),
            ("/tfs", "geometry_msgs/TransformStamped", {
                "header": hdr, "child_frame_id": "base",
                "transform": {"translation": rng.normal(size=3),
                              "rotation": np.array([0, 0, 0, 1.0])}}, t),
            ("/tf", "tf2_msgs/TFMessage", tf_msg("odom", "base", np.eye(4), t), t),
            ("/cloud", "sensor_msgs/PointCloud2", j_rb.xyz_to_pointcloud2(
                rng.normal(size=(5, 3)).astype(np.float32), stamp=t, frame_id="lidar"), t),
        ]
    out.append(("/info", "sensor_msgs/CameraInfo", {
        "header": {"stamp": 100.0}, "height": 12, "width": 32, "distortion_model": "plumb_bob",
        "D": rng.normal(size=5), "K": K.reshape(-1), "R": np.eye(3).reshape(-1),
        "P": np.concatenate([K, np.zeros((3, 1))], 1).reshape(-1)}, 100.0))
    return out


def write_bag(mod, path, messages, compression="none"):
    with mod.BagWriter(path, compression=compression, chunk_messages=7) as w:
        for topic, msgtype, msg, t in messages:
            w.write(topic, msgtype, msg, t)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
@pytest.mark.parametrize("writer", ["port", "roman_tpu"])
def test_ros1_bags_read_both_ways(tmp_path, writer, compression):
    """A bag of every message type written by one package reads the same
    through either; both writers write the same bytes."""
    messages = every_message()
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.bag")
        write_bag(mod, paths[name], messages, compression)
    with open(paths["port"], "rb") as a, open(paths["roman_tpu"], "rb") as b:
        assert a.read() == b.read()
    path = paths[writer]
    j_reader, t_reader = j_rb.BagReader(path), t_rb.BagReader(path)
    assert t_reader.topics == j_reader.topics
    for topic in j_reader.topics:
        got = list(t_reader.read_messages(topic))
        ref = list(j_reader.read_messages(topic))
        assert len(got) == len(ref) > 0
        for (tc, tm, tt), (jc, jm, jt) in zip(got, ref):
            assert tt == jt
            assert_same(tm, jm, topic)
    for topic, mod_fn in (("/rgb", "read_images"), ("/png", "read_images"),
                          ("/odom", "read_poses"), ("/tf", "read_poses"),
                          ("/cloud", "read_pointclouds")):
        assert_same(getattr(t_rb, mod_fn)(path, topic), getattr(j_rb, mod_fn)(path, topic),
                    topic)
    assert_same(t_rb.read_camera_info(path, "/info"), j_rb.read_camera_info(path, "/info"))
    raw = j_rb.serialize("tf2_msgs/TFMessage", tf_msg("map", "odom", np.eye(4), 1.0))
    assert_same(t_rb.deserialize("tf/tfMessage", raw), j_rb.deserialize("tf/tfMessage", raw))


def test_lz4_codec_matches_and_interoperates():
    rng = np.random.default_rng(1)
    payloads = [b"", b"abc", bytes(range(256)) * 700,
                rng.integers(0, 4, 5000, dtype=np.uint8).tobytes()]
    for data in (b"", b"Hello World", payloads[-1]):
        assert t_lz4.xxh32(data) == j_lz4.xxh32(data)
    for data in payloads:
        frame = t_lz4.compress_frame(data, block_size=1 << 10)
        assert frame == j_lz4.compress_frame(data, block_size=1 << 10)
        assert j_lz4.decompress_frame(frame) == data
        assert t_lz4.decompress_frame(j_lz4.compress_frame(data)) == data
    # a block with an overlapping match copy
    blk = bytes([0x44]) + b"abcd" + bytes([0x04, 0x00]) + bytes([0x50]) + b"wxyz!"
    assert t_lz4.decompress_block(blk) == j_lz4.decompress_block(blk)
    with pytest.raises(ValueError, match="magic"):
        t_lz4.decompress_frame(b"\x00\x01\x02\x03\x04\x05\x06\x07")


def test_rosbag2_round_trip_both_ways_and_cdr_alignment(tmp_path):
    messages = [m for m in every_message(2)
                if m[1] in j_rb2._SERIALIZERS or m[1].replace("/", "/msg/", 1)
                in j_rb2._SERIALIZERS]
    assert messages
    for name, (w_mod, r_mods) in {"port": (t_rb2, (j_rb2, t_rb2)),
                                  "roman_tpu": (j_rb2, (t_rb2, j_rb2))}.items():
        path = str(tmp_path / name)
        with w_mod.Bag2Writer(path) as w:
            for topic, msgtype, msg, t in messages:
                w.write(topic, msgtype.replace("/", "/msg/", 1), msg, t)
        readers = [m.Bag2Reader(path) for m in r_mods]
        assert readers[0].topics == readers[1].topics
        for topic in readers[0].topics:
            for a, b in zip(readers[0].read_messages(topic), readers[1].read_messages(topic)):
                assert a[2] == b[2]
                assert_same(a[1], b[1], topic)
        # the high-level readers dispatch to rosbag2 by path
        assert_same(t_rb.read_poses(path, "/odom"), j_rb.read_poses(path, "/odom"))
        assert_same(t_rb.read_images(path, "/rgb"), j_rb.read_images(path, "/rgb"))
    m = {"header": {"stamp": 12.25, "frame_id": "abc"}, "child_frame_id": "x",
         "transform": {"translation": np.array([1.0, 2.0, 3.0]),
                       "rotation": np.array([0.0, 0.0, 0.0, 1.0])}}
    raw = t_rb2.serialize("geometry_msgs/msg/TransformStamped", m)
    assert raw == j_rb2.serialize("geometry_msgs/msg/TransformStamped", m)
    assert_same(t_rb2.deserialize("geometry_msgs/msg/TransformStamped", raw),
                j_rb2.deserialize("geometry_msgs/msg/TransformStamped", raw))


def _frames(rng, n=3, H=12, W=16):
    times = 1000.0 + 0.5 * np.arange(n)
    imgs = rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
    depths = rng.integers(500, 5000, (n, H, W)).astype(np.uint16)
    return times, imgs, depths


def assert_same_img_data(t, j):
    np.testing.assert_array_equal(t.times, j.times)
    np.testing.assert_array_equal(t.images, j.images)
    assert t.images.dtype == j.images.dtype
    if j.depths is None:
        assert t.depths is None
    else:
        np.testing.assert_array_equal(t.depths, j.depths)
        assert t.depths.dtype == j.depths.dtype


@pytest.mark.parametrize("source", ["npz", "dir", "zip", "bag"])
def test_img_data_matches_roman_tpu(tmp_path, source):
    """ImgData from each source, against roman_tpu (which reads image files
    with cv2): PNG color and 16-bit depth, and a JPEG frame in dir and
    zip."""
    cv = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    times, imgs, depths = _frames(rng)
    if source == "npz":
        path = str(tmp_path / "a.npz")
        np.savez(path, times=times, images=imgs, depths=depths)
        got, ref = TImgData.from_npz(path, 1000.0), JImgData.from_npz(path, 1000.0)
    elif source == "bag":
        path = str(tmp_path / "a.bag")
        with t_rb.BagWriter(path) as w:
            for k, t in enumerate(times):
                w.write("/c", "sensor_msgs/CompressedImage", {
                    "header": {"stamp": t}, "format": "png",
                    "data": png.encode_png(imgs[k])}, t)
                w.write("/d", "sensor_msgs/Image", t_rb.array_to_image(depths[k], stamp=t), t)
        got = TImgData.from_bag(path, "/c", depth_topic="/d")
        ref = JImgData.from_bag(path, "/c", depth_topic="/d")
    else:
        files = {}
        for k, t in enumerate(times):
            ext = ".jpg" if k == 1 else ".png"
            files[f"{t:.6f}{ext}"] = cv.imencode(ext, imgs[k][..., ::-1])[1].tobytes()
            files[f"depth/{t:.6f}{ext}"] = cv.imencode(".png", depths[k])[1].tobytes()
        if source == "dir":
            path = tmp_path / "frames"
            (path / "depth").mkdir(parents=True)
            for name, data in files.items():
                (path / name).write_bytes(data)
            got, ref = TImgData.from_dir(str(path)), JImgData.from_dir(str(path))
        else:
            path = str(tmp_path / "frames.zip")
            with zipfile.ZipFile(path, "w") as zf:
                for name, data in files.items():
                    zf.writestr(name, data)
            got, ref = TImgData.from_zip(path), JImgData.from_zip(path)
    assert got.images.shape == (3, 12, 16, 3)
    assert_same_img_data(got, ref)


def test_jpeg_without_opencv_raises_an_import_error_naming_it(tmp_path, monkeypatch):
    """PNG needs no OpenCV; JPEG does, and asks for it by name."""
    rng = np.random.default_rng(4)
    times, imgs, depths = _frames(rng, n=2)
    d = tmp_path / "frames"
    d.mkdir()
    for k, t in enumerate(times):
        png.write_png(str(d / f"{t:.6f}.png"), imgs[k])
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = TImgData.from_dir(str(d))
    np.testing.assert_array_equal(got.images, imgs)
    (d / "1002.000000.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    with pytest.raises(ImportError, match="cv2"):
        TImgData.from_dir(str(d))
    bag = str(tmp_path / "jpg.bag")
    with t_rb.BagWriter(bag) as w:
        w.write("/c", "sensor_msgs/CompressedImage", {
            "header": {"stamp": 1.0}, "format": "jpeg", "data": b"\xff\xd8\xff"}, 1.0)
    with pytest.raises(ImportError, match="cv2"):
        t_rb.read_images(bag, "/c")


def test_pose_data_and_camera_params_from_bag(tmp_path):
    path = str(tmp_path / "a.bag")
    write_bag(j_rb, path, every_message(5))
    for topic in ("/odom", "/pose", "/posecov", "/tfs", "/tf"):
        got, ref = TPoseData.from_bag(path, topic, time_tol=0.5), \
            JPoseData.from_bag(path, topic, time_tol=0.5)
        np.testing.assert_array_equal(got.times, ref.times)
        np.testing.assert_array_equal(got.poses, ref.poses)
        np.testing.assert_array_equal(got.pose(100.1), ref.pose(100.1))
    spec = {"type": "bag", "path": path, "topic": "/odom", "time_tol": 2.0}
    np.testing.assert_array_equal(TPoseData.from_yaml_spec(spec).poses,
                                  JPoseData.from_yaml_spec(spec).poses)
    got, ref = TCameraParams.from_bag(path, "/info"), JCameraParams.from_bag(path, "/info")
    np.testing.assert_array_equal(got.K, ref.K)
    np.testing.assert_array_equal(got.D, ref.D)
    assert (got.width, got.height) == (ref.width, ref.height) == (32, 12)


def _rand_T(rng):
    q = rng.normal(size=4)
    return j_se3.xyz_quat_to_T(rng.normal(size=3), q / np.linalg.norm(q))


def _tf_bags(tmp_path):
    """The TF trees of tests/test_rosbag.py:445-620: (bag, parent, child,
    include_non_static, expected T or None for a KeyError)."""
    rng = np.random.default_rng(7)
    T_bc, T_bi, T_il = _rand_T(rng), _rand_T(rng), _rand_T(rng)
    T_true = j_se3.xyz_quat_to_T(np.array([1.0, 2.0, 3.0]), np.array([0, 0, 0, 1.0]))
    T_other = j_se3.xyz_quat_to_T(np.array([9.0, 9.0, 9.0]), np.array([0, 0, 0, 1.0]))
    bags = {
        # a static tree, looked up along a chain and against edge direction
        "chain": [("/tf_static", "base", "camera", T_bc, 0.0),
                  ("/tf_static", "base", "imu", T_bi, 0.0),
                  ("/tf_static", "imu", "lidar", T_il, 0.0)],
        # the same edge on /tf first and /tf_static later: static wins
        "shadow": [("/tf", "base", "camera", np.eye(4), 0.0),
                   ("/tf_static", "base", "camera", T_true, 5.0)],
        # the extrinsic only on /tf beside an unrelated static edge
        "fallback": [("/tf_static", "map", "odom", T_other, 0.0),
                     ("/tf", "base", "camera", T_true, 0.0),
                     ("/tf", "base", "camera", T_other, 1.0)],
        # a chain across /tf and /tf_static
        "mixed": [("/tf_static", "base", "camera", T_true, 0.0),
                  ("/tf", "odom", "base", T_other, 0.0)],
        # a direct /tf edge against a 2-hop static chain
        "prio": [("/tf", "base", "camera", np.eye(4), 0.0),
                 ("/tf_static", "base", "imu", T_bi, 1.0),
                 ("/tf_static", "imu", "camera", T_il, 1.0)],
    }
    paths = {}
    for name, edges in bags.items():
        paths[name] = str(tmp_path / f"{name}.bag")
        with t_rb.BagWriter(paths[name]) as w:
            for topic, a, b, T, t in edges:
                w.write(topic, "tf2_msgs/TFMessage", tf_msg(a, b, T), t)
    inv = np.linalg.inv
    return [
        (paths["chain"], "camera", "lidar", False, inv(T_bc) @ T_bi @ T_il),
        (paths["chain"], "lidar", "camera", False, inv(inv(T_bc) @ T_bi @ T_il)),
        (paths["chain"], "imu", "imu", False, np.eye(4)),
        (paths["chain"], "camera", "wheel", False, None),
        (paths["shadow"], "base", "camera", True, T_true),
        (paths["fallback"], "base", "camera", False, T_true),
        (paths["mixed"], "odom", "camera", False, T_other @ T_true),
        (paths["mixed"], "odom", "camera", True, T_other @ T_true),
        (paths["mixed"], "odom", "wheel", False, None),
        (paths["prio"], "base", "camera", True, T_bi @ T_il),
    ]


def test_static_first_tf_lookup_matches_roman_tpu(tmp_path):
    for bag, parent, child, non_static, expect in _tf_bags(tmp_path):
        if expect is None:
            for mod in (t_rb, j_rb):
                with pytest.raises(KeyError):
                    mod.read_static_transform(bag, parent, child, non_static)
            continue
        got = t_rb.read_static_transform(bag, parent, child, non_static)
        np.testing.assert_array_equal(
            got, j_rb.read_static_transform(bag, parent, child, non_static))
        np.testing.assert_allclose(got, expect, atol=1e-9)


DATA_YAMLS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("params/*/data.yaml"))


@pytest.mark.parametrize("path", DATA_YAMLS)
def test_data_params_match_roman_tpu(path, monkeypatch):
    """DataParams.from_yaml on every params/*/data.yaml, for every run,
    field for field, with T_camera_flu and (for sim and other bagless
    sources) the camera."""
    with open(ROOT / path) as f:
        runs = yaml.safe_load(f)["runs"]
    for run in [None] + runs:
        got = t_dp.DataParams.from_yaml(str(ROOT / path), run)
        ref = j_dp.DataParams.from_yaml(str(ROOT / path), run)
        for field in ("runs", "run_env", "time_params", "img_data_params",
                      "depth_data_params", "pose_data_params",
                      "pointcloud_data_params", "dt"):
            assert getattr(got, field) == getattr(ref, field), (path, run, field)
        if ref.T_camera_flu is None:
            assert got.T_camera_flu is None
        else:
            np.testing.assert_array_equal(got.T_camera_flu, ref.T_camera_flu)
        if (ref.img_data_params or {}).get("type") != "bag":
            got_cam, ref_cam = got.load_camera_params(), ref.load_camera_params()
            np.testing.assert_array_equal(got_cam.K, ref_cam.K)
            assert (got_cam.width, got_cam.height) == (ref_cam.width, ref_cam.height)
        monkeypatch.delenv("ROBOT", raising=False)
        got.set_run_env("x")
        assert os.environ.get(got.run_env or "ROBOT") == ("x" if got.run_env else None)
    np.testing.assert_array_equal(t_dp.T_FLURDF, j_dp.T_FLURDF)
    np.testing.assert_array_equal(t_dp.T_RDFFLU, j_dp.T_RDFFLU)


def test_bag_data_params_with_run_env_and_tf_extrinsic(tmp_path, monkeypatch):
    """A run-env data.yaml over a ROS1 bag: poses post-multiplied by a
    TF-resolved extrinsic, per-run overrides, a depth_data block and the
    camera, against roman_tpu."""
    rng = np.random.default_rng(8)
    T_bc = _rand_T(rng)
    for robot in ("r0", "r1"):
        with t_rb.BagWriter(str(tmp_path / f"{robot}.bag")) as w:
            w.write("/tf_static", "tf2_msgs/TFMessage", tf_msg("base", "camera", T_bc), 0.0)
            for topic, msgtype, msg, t in every_message(9 if robot == "r0" else 10):
                w.write(topic, msgtype, msg, t)
    spec = {"runs": ["r0", "r1"], "run_env": "ROBOT", "dt": 0.25,
            "time": {"relative": True, "t0": 0.0, "tf": 10.0},
            "img_data": {"type": "bag", "path": str(tmp_path / "${ROBOT}.bag"),
                         "topic": "/rgb", "camera_info_topic": "/info"},
            "depth_data": {"type": "bag", "path": str(tmp_path / "${ROBOT}.bag"),
                           "topic": "/mono16", "depth_scale": 1000.0},
            "pose_data": {"type": "bag", "path": str(tmp_path / "${ROBOT}.bag"),
                          "topic": "/odom", "time_tol": 10.0,
                          "T_postmultiply": {"input_type": "tf", "parent": "base",
                                             "child": "camera"},
                          "T_camera_flu": {"input_type": "string", "string": "T_RDFFLU"}},
            "r1": {"dt": 0.5, "pose_data": {"topic": "/pose"}}}
    yml = tmp_path / "data.yaml"
    yml.write_text(yaml.safe_dump(spec))
    for robot in ("r0", "r1"):
        monkeypatch.setenv("ROBOT", robot)
        got = t_dp.DataParams.from_yaml(str(yml), robot)
        ref = j_dp.DataParams.from_yaml(str(yml), robot)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        pd_t, pd_j = got.load_pose_data(), ref.load_pose_data()
        np.testing.assert_array_equal(pd_t.poses, pd_j.poses)
        assert pd_t.time_tol == pd_j.time_tol == 10.0
        odom = TPoseData.from_bag(str(tmp_path / f"{robot}.bag"), got.pose_data_params["topic"])
        np.testing.assert_allclose(pd_t.poses, odom.poses @ T_bc, atol=1e-12)
        np.testing.assert_array_equal(got.T_camera_flu, ref.T_camera_flu)
        cam_t, cam_j = got.load_camera_params(), ref.load_camera_params()
        np.testing.assert_array_equal(cam_t.K, cam_j.K)
    assert got.dt == 0.5


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """PNG bytes of img with the given filter type on each row in turn
    (0 none, 1 sub, 2 up, 3 average, 4 paeth), built by hand."""
    import struct
    import zlib

    body = (img.astype(">u2") if img.dtype == np.uint16 else img)
    h = img.shape[0]
    rows = body.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = (img.shape[2] if img.ndim == 3 else 1) * img.dtype.itemsize
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(f)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[2] if img.ndim == 3 else 1]
    depth = 8 * img.dtype.itemsize

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_matches_cv2(dtype, channels):
    """decode_png against cv2.imdecode on seeded images of each bit depth
    and colour type, with every row filter, and on cv2's own encoding;
    encode_png's RGB round trip."""
    cv = pytest.importorskip("cv2")
    rng = np.random.default_rng(channels)
    hi = np.iinfo(dtype).max + 1
    img = rng.integers(0, hi, (13, 11, channels)).astype(dtype)
    img[:6] = (np.add.outer(np.arange(6) * 7, np.arange(11) * 3)[..., None] % hi).astype(dtype)
    want = img[..., 0] if channels == 1 else img
    encodings = [_filtered_png(img, [0, 1, 2, 3, 4]), _filtered_png(img, [4, 3]),
                 _filtered_png(img, [0])]
    if channels != 2:  # cv2 writes no gray-alpha
        bgr = want if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
        encodings.append(cv.imencode(".png", bgr)[1].tobytes())
    for data in encodings:
        got = png.decode_png(data)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == dtype
        ref = cv.imdecode(np.frombuffer(data, np.uint8), cv.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
        if channels == 2:  # cv2 reads gray+alpha as BGRA
            np.testing.assert_array_equal(ref[..., 0], got[..., 0])
            np.testing.assert_array_equal(ref[..., 3], got[..., 1])
        else:
            np.testing.assert_array_equal(got, ref)
        color = cv.imdecode(np.frombuffer(data, np.uint8), cv.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(png.to_color(got), color)
    if channels == 3 and dtype == np.uint8:
        np.testing.assert_array_equal(png.decode_png(png.encode_png(img)), img)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"\xff\xd8\xff")
