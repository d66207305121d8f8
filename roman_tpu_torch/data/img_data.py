"""Image/depth sequence loading (host copy of roman_tpu/data/img_data.py).

Standalone replacement for robotdatapy's ImgData (reference
data_params.py:200-294 loads ROS bags / zips). Supported sources: npz
archives (images uint8 (T,H,W,3), depths (T,H,W) float, times (T,)),
directories and zips of image files named <t_ns>.png with an optional
depth/ subdir, and ROS1 bags or rosbag2 recordings. PNG files are decoded
with zlib and numpy (roman_tpu_torch.data.png), as cv2.imread reads them;
JPEG files need OpenCV. Nearest-time indexing mirrors
ImgData.nearest_time/img usage (reference run.py:129-138).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from roman_tpu_torch.data import png
from roman_tpu_torch.utils import require


def _decode_file(name: str, data: bytes, color: bool) -> Optional[np.ndarray]:
    """An image file's bytes as cv2.imread/imdecode read them: color as
    (H, W, 3) uint8 RGB (IMREAD_COLOR, then BGR -> RGB), else unchanged
    (depth). None where cv2 would return None (an unreadable file)."""
    if data.startswith(png.SIGNATURE):
        img = png.decode_png(data)
        return png.to_color(img) if color else img
    cv = require("cv2", f"reading {name!r}")
    img = cv.imdecode(np.frombuffer(data, np.uint8),
                      cv.IMREAD_COLOR if color else cv.IMREAD_UNCHANGED)
    if img is None or not color:
        return img
    return img[..., ::-1]  # BGR -> RGB


def _stamp(name: str) -> Optional[float]:
    """The time in a file name: <t_ns> (more than 12 digits) or <t_s>."""
    stem = os.path.splitext(os.path.basename(name))[0]
    try:
        return float(stem) * (1e-9 if len(stem) > 12 else 1.0)
    except ValueError:
        return None


@dataclasses.dataclass
class ImgData:
    times: np.ndarray                    # (T,)
    images: np.ndarray                   # (T, H, W, 3) uint8
    depths: Optional[np.ndarray] = None  # (T, H, W) float meters

    def __post_init__(self):
        order = np.argsort(self.times)
        self.times = np.asarray(self.times)[order]
        self.images = np.asarray(self.images)[order]
        if self.depths is not None:
            self.depths = np.asarray(self.depths)[order]

    @classmethod
    def from_npz(cls, path: str, depth_scale: float = 1.0) -> "ImgData":
        arr = np.load(os.path.expanduser(path))
        depths = arr["depths"].astype(np.float32) / depth_scale if "depths" in arr else None
        return cls(times=arr["times"], images=arr["images"], depths=depths)

    @classmethod
    def from_dir(cls, path: str, depth_subdir: str = "depth",
                 depth_scale: float = 1000.0) -> "ImgData":
        path = os.path.expanduser(path)
        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        times, imgs, depths = [], [], []
        ddir = os.path.join(path, depth_subdir)
        has_depth = os.path.isdir(ddir)
        for f in files:
            t = _stamp(f)
            if t is None:
                continue
            with open(os.path.join(path, f), "rb") as fh:
                img = _decode_file(f, fh.read(), color=True)
            if img is None:
                continue
            if has_depth:
                dpath = os.path.join(ddir, f)
                d = None
                if os.path.exists(dpath):
                    with open(dpath, "rb") as fh:
                        d = _decode_file(dpath, fh.read(), color=False)
                if d is None:
                    raise FileNotFoundError(
                        f"color frame {f!r} has no readable depth image at "
                        f"{dpath!r}")
                depths.append(np.asarray(d, np.float32) / depth_scale)
            times.append(t)
            imgs.append(img)
        return cls(
            times=np.asarray(times),
            images=np.stack(imgs),
            depths=np.stack(depths) if depths else None,
        )

    @classmethod
    def from_bag(cls, path: str, topic: str, depth_topic: str = None,
                 depth_scale: float = 1000.0) -> "ImgData":
        """ROS1 bag or rosbag2 ingestion (reference loads bags via
        robotdatapy, data_params.py:200-294) through the pure-python
        reader in roman_tpu_torch.data.rosbag — no ROS installation
        needed. Color topics may be Image or CompressedImage; depth topics
        16UC1/mono16 (scaled by depth_scale) or 32FC1 (meters)."""
        from roman_tpu_torch.data import rosbag

        times, images = rosbag.read_images(path, topic)
        if images.ndim == 3:  # mono stream -> replicate to 3 channels
            images = np.repeat(images[..., None], 3, axis=-1)
        depths = None
        if depth_topic is not None:
            dt_, darr = rosbag.read_images(path, depth_topic)
            if darr.dtype != np.float32:
                darr = darr.astype(np.float32) / depth_scale
            # match each color frame to the nearest depth frame, but
            # only within a time tolerance (the frame period, min 50 ms)
            # — robotdatapy applies a tolerance; silently pairing with a
            # far-away depth frame corrupts geometry
            idx = np.argmin(np.abs(dt_[None, :] - times[:, None]), axis=1)
            dt_err = np.abs(dt_[idx] - times)
            period = (np.median(np.diff(times)) if len(times) > 1 else 0.05)
            tol = max(float(period), 0.05)
            depths = darr[idx]
            bad = dt_err > tol
            if np.any(bad):
                depths = depths.copy()
                depths[bad] = 0.0  # zero depth == no measurement
        return cls(times=times, images=images, depths=depths)

    @classmethod
    def from_zip(cls, path: str, depth_subdir: str = "depth",
                 depth_scale: float = 1000.0) -> "ImgData":
        """Zip archives of timestamp-named images (the reference ingests
        image zips via robotdatapy, README.md:122). Layout mirrors
        from_dir: color images at the root (or any folder), depth images
        under <depth_subdir>/ with matching names."""
        import zipfile

        times, imgs, depths = [], [], []
        with zipfile.ZipFile(os.path.expanduser(path)) as zf:
            names = [n for n in zf.namelist()
                     if n.lower().endswith((".png", ".jpg", ".jpeg"))]
            color = sorted(n for n in names
                           if f"{depth_subdir}/" not in n)
            depth_names = {os.path.basename(n): n for n in names
                           if f"{depth_subdir}/" in n}
            for n in color:
                t = _stamp(n)
                if t is None:
                    continue
                img = _decode_file(n, zf.read(n), color=True)
                if img is None:
                    continue
                dn = depth_names.get(os.path.basename(n))
                if depth_names and dn is None:
                    # depth frames pair with color by INDEX downstream —
                    # a silently skipped depth would misalign every
                    # later frame, so missing entries are an error
                    raise FileNotFoundError(
                        f"color frame {n!r} has no matching depth entry "
                        f"under {depth_subdir}/")
                if dn is not None:
                    d = _decode_file(dn, zf.read(dn), color=False)
                    if d is None:
                        raise ValueError(f"undecodable depth image {dn!r}")
                    depths.append(np.asarray(d, np.float32) / depth_scale)
                times.append(t)
                imgs.append(img)
        return cls(
            times=np.asarray(times),
            images=np.stack(imgs),
            depths=np.stack(depths) if depths else None,
        )

    def idx(self, t) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, np.float64))
        return np.argmin(np.abs(self.times[None, :] - t[:, None]), axis=1)

    def nearest(self, t):
        """(images, depths) at the nearest frames to times t."""
        i = self.idx(t)
        return self.images[i], (self.depths[i] if self.depths is not None else None)

    @property
    def t0(self):
        return float(self.times[0])

    @property
    def tf(self):
        return float(self.times[-1])
