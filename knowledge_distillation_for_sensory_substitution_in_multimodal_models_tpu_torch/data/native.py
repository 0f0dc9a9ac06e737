"""ctypes binding of the native host-preprocessing library (port of the JAX
package's ``data/native.py``): ``native/depth_ops.cc``, the Prewitt depth
encoding in OpenMP C++ (the reference's CPU hot loop #1, SURVEY.md §3.1).

The library is built at first use from the source in this checkout, with
``native/build.sh``'s flags (``g++ -O3 -march=native -fopenmp -shared
-fPIC``), into ``build/native/libdepthops_<hash>.so`` at the root of the
checkout; the hash covers the source, the flags and the host CPU's feature
flags (``-march=native`` code runs only where it was built), so an edited
source or another machine builds anew and an unchanged one loads the file.
The prebuilt ``native/libdepthops.so`` is never read.  A build that fails
raises with the compiler's output; nothing falls back.  The numpy encoding
``data/depth.py::depth_to_3ch_numpy`` stays as the plain version, which
:func:`depth_to_3ch_native` equals bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "depth_ops.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which ``-march=native`` reads."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    """build/native/libdepthops_<hash>.so for this source, flags and CPU."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libdepthops_{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """Compile the source into ``out`` (atomically); raise RuntimeError with
    the compiler's output if it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        lib = Path(tmpdir) / out.name
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(lib)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The library, built first if this source has none yet."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    sig = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
           ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
    for name in ("depth_to_3ch", "depth_to_3ch_bake"):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = None
    return lib


def native_available() -> bool:
    """Whether the library is built or builds here (the build's error
    itself is raised by :func:`depth_to_3ch_native`)."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def depth_to_3ch_native(depth: np.ndarray, imagenet_bake: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] Prewitt encoding of raw depth [H, W], bit-exact to
    ``depth_to_3ch_numpy``; ``imagenet_bake=True`` also applies the
    reference's eval-path ImageNet bake (`evaluate_onevision.py:279-288`)
    in the same native pass."""
    lib = load_library()
    if depth.ndim != 2:
        raise ValueError(f"depth must be [H, W], got shape {depth.shape}")
    h, w = depth.shape
    src = np.ascontiguousarray(depth, dtype=np.float32)
    out = np.empty((h, w, 3), dtype=np.uint8)
    scratch = np.empty(4 * h * w, dtype=np.float32)
    fn = lib.depth_to_3ch_bake if imagenet_bake else lib.depth_to_3ch
    fn(src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
       scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
