"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled into its own shared library with a plain C
interface, all nvcc processes started together, into
``build/roman_tpu_torch/`` at the root of the checkout (listed in
.gitignore). A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is rebuilt and a stale
one is never loaded. The build runs on first use, so importing a module
needs no compiler: the CPU tests import every module on hosts without
nvcc.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` so that no
multiply-add is contracted and the affinity build rounds each operation
as the plain PyTorch twin does, and ``-Xptxas -v`` so the build log shows
each kernel's registers and spills. No fast math: the bf16 rounding of
the affinity depends on full-precision expf/logf/sqrtf and IEEE division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "roman_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, the toolkit's default location,
    or the first one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(src: Path) -> Path:
    h = hashlib.sha1()
    for f in [src] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}.{h.hexdigest()[:16]}.so"


def build_all() -> str:
    """Compile every csrc/*.cu that has no current library, one nvcc per
    source, all started together; load every library. Returns the
    compiler output of this call (empty when nothing was built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cu"))
    jobs = []
    for src in sources:
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    for src in sources:
        if src.stem not in _libs:
            _libs[src.stem] = ctypes.CDLL(str(_library_path(src)))
    return "\n".join(log)


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``name`` of ``csrc/<lib>.cu`` with its argtypes set
    (every pointer and the stream as c_void_p, so none is cut to 32 bits)
    and an int return: the cudaError_t of the launch."""
    key = (lib, name)
    if key not in _functions:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check_tensor(name: str, x, shape, dtype, device) -> None:
    """Raise unless x is a contiguous tensor of this shape and dtype on
    this device: what a kernel reads through a raw pointer."""
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def check_launch(kernel: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
