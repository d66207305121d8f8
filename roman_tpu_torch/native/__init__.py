"""The port's host C++ runtime, bound with ctypes (port of
roman_tpu/native/__init__.py).

- ``parse_g2o_native``: a g2o text parser (``g2o_parser.cpp``), the array
  form of ``rpgo.g2o_io.parse_g2o``;
- ``hungarian_native``: an O(n^3) Jonker-Volgenant linear assignment
  (``g2o_parser.cpp``);
- ``clipper_ref_solve_native``: the serial per-pair CLIPPER solve
  (``clipper_ref.cpp``), the referee the batched engine is timed and held
  against, standing in for the reference's Eigen clipperpy loop.

Both sources are compiled with ``g++ -O3 -shared -fPIC`` into one library
under ``build/roman_tpu_torch/native/`` at the root of the checkout
(listed in .gitignore) on first use, never into the package. The file
name carries a hash of the sources and the flags, so an edited source is
rebuilt and a stale library never loaded; the build writes a temporary
name and renames it, so concurrent processes do not race. A failed build
raises with g++'s output; no function returns None in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from roman_tpu_torch.kernels import build

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "g2o_parser.cpp", _DIR / "clipper_ref.cpp")
BUILD_DIR = build.BUILD_DIR / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha1()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libroman_native.{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native runtime needs a C++ "
                           "compiler on PATH") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.g2o_parse.restype = ctypes.c_void_p
            lib.g2o_parse.argtypes = [ctypes.c_char_p]
            lib.g2o_num_vertices.restype = ctypes.c_int64
            lib.g2o_num_vertices.argtypes = [ctypes.c_void_p]
            lib.g2o_num_edges.restype = ctypes.c_int64
            lib.g2o_num_edges.argtypes = [ctypes.c_void_p]
            lib.g2o_get_vertices.restype = None
            lib.g2o_get_vertices.argtypes = [ctypes.c_void_p] * 3
            lib.g2o_get_edges.restype = None
            lib.g2o_get_edges.argtypes = [ctypes.c_void_p] * 6
            lib.g2o_free.restype = None
            lib.g2o_free.argtypes = [ctypes.c_void_p]
            lib.hungarian_solve.restype = None
            lib.hungarian_solve.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
            lib.clipper_ref_solve.restype = ctypes.c_int
            lib.clipper_ref_solve.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_double] * 5 + [ctypes.c_void_p])
            _lib = lib
    return _lib


def parse_g2o_native(path: str):
    """Returns (keys (V,), vert_xyzq (V, 7), v1 (E,), v2 (E,), edge_xyzq
    (E, 7), info_upper (E, 21), lc_counts (E,), -1 where an edge has no
    `# LC:` line). Raises FileNotFoundError for a missing file and
    ValueError for a line the parser refuses."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    lib = get_lib()
    h = lib.g2o_parse(os.fsencode(path))
    if not h:
        raise ValueError(f"{path}: not a g2o file the parser reads")
    try:
        V = lib.g2o_num_vertices(h)
        E = lib.g2o_num_edges(h)
        keys = np.empty(V, np.int64)
        vx = np.empty((V, 7), np.float64)
        lib.g2o_get_vertices(h, keys.ctypes.data, vx.ctypes.data)
        v1 = np.empty(E, np.int64)
        v2 = np.empty(E, np.int64)
        ex = np.empty((E, 7), np.float64)
        info = np.empty((E, 21), np.float64)
        lc = np.empty(E, np.int64)
        lib.g2o_get_edges(h, v1.ctypes.data, v2.ctypes.data, ex.ctypes.data,
                          info.ctypes.data, lc.ctypes.data)
        return keys, vx, v1, v2, ex, info, lc
    finally:
        lib.g2o_free(h)


def hungarian_native(cost: np.ndarray) -> np.ndarray:
    """Minimizing assignment of an (n, m) cost: the column of each row
    (int32, -1 where a row is unassigned)."""
    cost = np.ascontiguousarray(cost, np.float64)
    if cost.ndim != 2:
        raise ValueError(f"cost must be 2-D, got shape {cost.shape}")
    n, m = cost.shape
    if n > m:  # solve the transpose, then invert its matching
        match = np.full(n, -1, np.int32)
        for j, i in enumerate(hungarian_native(cost.T)):
            if i >= 0:
                match[i] = j
        return match
    match = np.full(n, -1, np.int32)
    get_lib().hungarian_solve(cost.ctypes.data, n, m, match.ctypes.data)
    return match


def clipper_ref_solve_native(c1, r1, d1, c2, r2, d2, sigma, epsilon, mindist,
                             cos_min, cos_max):
    """Serial per-pair C++ CLIPPER solve of one pair: centers (n, 3), ratio
    features (n, F) and descriptors (n, D) of each side. Returns a list of
    (a, b) association index pairs."""
    c1, r1, d1, c2, r2, d2 = (np.ascontiguousarray(x, np.float64)
                              for x in (c1, r1, d1, c2, r2, d2))
    n1, n2 = len(c1), len(c2)
    if not (len(r1) == len(d1) == n1 and len(r2) == len(d2) == n2
            and r1.shape[1] == r2.shape[1] and d1.shape[1] == d2.shape[1]
            and c1.shape[1:] == c2.shape[1:] == (3,)):
        raise ValueError("clipper_ref_solve_native: the two sides' arrays "
                         "disagree in shape")
    sel = np.empty((min(n1, n2), 2), np.int32)
    n = get_lib().clipper_ref_solve(
        c1.ctypes.data, r1.ctypes.data, d1.ctypes.data, n1,
        c2.ctypes.data, r2.ctypes.data, d2.ctypes.data, n2,
        r1.shape[1], d1.shape[1],
        float(sigma), float(epsilon), float(mindist),
        float(cos_min), float(cos_max),
        sel.ctypes.data)
    return [tuple(p) for p in sel[:n]]
