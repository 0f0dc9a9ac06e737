"""Build and load the CUDA kernel library.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles the sources under ``csrc/`` into a shared library with a plain C
interface, loaded with ``ctypes``.  The library is built at first use into
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing file.  A build that fails raises; nothing falls back.

Nothing here runs at import: ``load_library`` is called by the first kernel
launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills go to the build log
)


def sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """build/kernels/libkdss_kernels_<hash>.so for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libkdss_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(out: Path) -> None:
    """Compile every source into ``out`` (atomically), log beside it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}); log in {log}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kdss_flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                   ctypes.c_float, vp]
    lib.kdss_flash_fwd.restype = ci
    lib.kdss_cuda_error_string.argtypes = [ci]
    lib.kdss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_fwd(q, k, v, kv_mask_u8, out, causal: bool, scale: float) -> None:
    """Launch the flash forward kernel on the current stream.

    Arguments are checked by ``flash_attention.kernel_args``; pointers must
    stay alive until the kernel ends, which the caller's references ensure
    (the launch is stream-ordered with their later use)."""
    lib = load_library()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and out must be 16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kdss_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask_u8 is None else kv_mask_u8.data_ptr(),
            out.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), float(scale), stream,
        )
    if err != 0:
        msg = lib.kdss_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} ({msg})")
