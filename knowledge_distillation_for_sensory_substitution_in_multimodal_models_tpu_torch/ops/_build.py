"""Build and load the CUDA kernel library.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` compiles each source
under ``csrc/`` (``*.cu``; the ``*.cuh`` headers are hashed, not compiled)
into an object, all at once in parallel, and links them into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
built at first use into ``build/kernels/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing file.  A build that fails raises;
nothing falls back.

Nothing here runs at import: ``load_library`` is called by the first kernel
launch.  The launchers below take tensors already checked by the op
modules (``flash_attention``, ``fused_ce``, ``fused_loca``, ``fused_kl``,
``int8``);
pointers stay alive until the kernels end because the callers hold the
tensors and the launches are ordered on the current stream with their
later use.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    """Compile every ``.cu`` to an object in parallel, link them into
    ``out`` (atomically), and write the compilers' output beside it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = Path(tmpdir) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            logs.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text[-3000:]}")
        lib = Path(tmpdir) / out.name
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(lib), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-3000:]}")
        log = out.with_suffix(".log")
        log.write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed; log in {log}:\n" + "\n".join(failed))
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # q, k, v, kv_mask, out, lse, B, Sq, Skv, Hq, Hkv, D, causal, scale, stream
        "kdss_flash_fwd": [vp] * 6 + [ci] * 7 + [cf, vp],
        # q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D, causal, scale, stream
        "kdss_flash_bwd": [vp] * 10 + [ci] * 7 + [cf, vp],
        # h, w, labels, lse_part, gold_part, lse, gold, N, V, DM, nsplit, stream
        "kdss_ce_fwd": [vp] * 7 + [ci] * 4 + [vp],
        # h, w, labels, lse, g_lse, g_gold, dh_part, dh, dw, N, V, DM, nsplit, stream
        "kdss_ce_bwd": [vp] * 9 + [ci] * 4 + [vp],
        # h, w, tmat, lab, lab_ce, part, rowstats, kl, ce, N, V, DM, nsplit,
        # inv_t, alpha, log_eps, stream
        "kdss_loca_ce_fwd": [vp] * 9 + [ci] * 4 + [cf] * 3 + [vp],
        # h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, dh_part, dh, dw, N, V, DM,
        # nsplit, inv_t, log_eps, stream
        "kdss_loca_ce_bwd": [vp] * 11 + [ci] * 4 + [cf] * 2 + [vp],
        # h, w, tmat, lab, part, rowstats, kl, N, V, DM, nsplit, inv_t, alpha,
        # log_eps, stream
        "kdss_loca_fwd": [vp] * 7 + [ci] * 4 + [cf] * 3 + [vp],
        # h, w, tmat, lab, rowstats, g, dh_part, dh, dw (or null), N, V, DM,
        # nsplit, inv_t, log_eps, stream
        "kdss_loca_bwd": [vp] * 9 + [ci] * 4 + [cf] * 2 + [vp],
        # h, w, tmat, part, kl, lse_s, lse_t, N, V, DM, nsplit, inv_t, stream
        "kdss_kl_fwd": [vp] * 7 + [ci] * 4 + [cf, vp],
        # h, w, tmat, lse_s, lse_t, g, dh_part, dh, dw (or null), N, V, DM, nsplit,
        # inv_t, stream
        "kdss_kl_bwd": [vp] * 9 + [ci] * 4 + [cf, vp],
        # x, xq, xs, N, K, k_block, div_scale, stream
        "kdss_int8_quantize": [vp] * 3 + [ci] * 4 + [vp],
        # xq, xs, wq, ws, out, N, K, M, k_block, out_f32, stream
        "kdss_int8_gemm": [vp] * 5 + [ci] * 5 + [vp],
        # h, wq, ws, out, N, V, D, inv_t, stream
        "kdss_tmat_int8": [vp] * 4 + [ci] * 3 + [cf, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    lib.kdss_cuda_error_string.argtypes = [ci]
    lib.kdss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, device, *args) -> None:
    """Call ``name`` on the current stream of ``device``; raise on an error."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.kdss_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _aligned(*ts) -> None:
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def flash_fwd(q, k, v, kv_mask_u8, out, lse, causal: bool, scale: float) -> None:
    """Flash forward (K1/K3); ``lse`` f32 [B, Hq, Sq] or None."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _aligned(q, k, v, out)
    _launch("kdss_flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask_u8), out.data_ptr(), _ptr(lse),
            b, sq, skv, hq, hkv, d, int(causal), float(scale))


def flash_bwd(q, k, v, kv_mask_u8, dout, lse, delta, dq, dk, dv, causal: bool,
              scale: float) -> None:
    """Flash backward (K2/K4): dq, dk, dv from the saved lse and delta."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _aligned(q, k, v, dout, dq, dk, dv)
    _launch("kdss_flash_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask_u8), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, hq, hkv, d, int(causal), float(scale))


def ce_fwd(h, w, labels, lse_part, gold_part, lse, gold) -> None:
    """Fused CE forward (K5) over a [V, DM] head."""
    n, dm = h.shape
    _aligned(h, w)
    _launch("kdss_ce_fwd", h.device, h.data_ptr(), w.data_ptr(), labels.data_ptr(),
            lse_part.data_ptr(), gold_part.data_ptr(), lse.data_ptr(), gold.data_ptr(),
            n, w.shape[0], dm, lse_part.shape[0])


def ce_bwd(h, w, labels, lse, g_lse, g_gold, dh_part, dh, dw) -> None:
    """Fused CE backward (K6): dh and dW over a [V, DM] head."""
    n, dm = h.shape
    _aligned(h, w, dh, dw)
    _launch("kdss_ce_bwd", h.device, h.data_ptr(), w.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g_lse.data_ptr(), g_gold.data_ptr(), dh_part.data_ptr(),
            dh.data_ptr(), dw.data_ptr(), n, w.shape[0], dm, dh_part.shape[0])


def loca_ce_fwd(h, w, tmat, lab, lab_ce, part, rowstats, kl, ce, inv_t, alpha, log_eps) -> None:
    """Combined LoCa + CE forward (K11) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix."""
    n, dm = h.shape
    _aligned(h, w)
    _launch("kdss_loca_ce_fwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(),
            lab.data_ptr(), lab_ce.data_ptr(), part.data_ptr(), rowstats.data_ptr(),
            kl.data_ptr(), ce.data_ptr(), n, w.shape[0], dm, part.shape[1],
            float(inv_t), float(alpha), float(log_eps))


def loca_ce_bwd(h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, dh_part, dh, dw, inv_t,
                log_eps) -> None:
    """Combined LoCa + CE backward (K11): dh and dW."""
    n, dm = h.shape
    _aligned(h, w, dh, dw)
    _launch("kdss_loca_ce_bwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(),
            lab.data_ptr(), lab_ce.data_ptr(), rowstats.data_ptr(), g_kl.data_ptr(),
            g_ce.data_ptr(), dh_part.data_ptr(), dh.data_ptr(), dw.data_ptr(), n, w.shape[0],
            dm, dh_part.shape[0], float(inv_t), float(log_eps))


def loca_fwd(h, w, tmat, lab, part, rowstats, kl, inv_t, alpha, log_eps) -> None:
    """LoCa forward without CE (K9) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix."""
    n, dm = h.shape
    _aligned(h, w)
    _launch("kdss_loca_fwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(), lab.data_ptr(),
            part.data_ptr(), rowstats.data_ptr(), kl.data_ptr(), n, w.shape[0], dm, part.shape[1],
            float(inv_t), float(alpha), float(log_eps))


def loca_bwd(h, w, tmat, lab, rowstats, g, dh_part, dh, dw, inv_t, log_eps) -> None:
    """LoCa backward without CE (K9): dh, and dW unless ``dw`` is None."""
    n, dm = h.shape
    _aligned(h, w, dh, dw)
    _launch("kdss_loca_bwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(), lab.data_ptr(),
            rowstats.data_ptr(), g.data_ptr(), dh_part.data_ptr(), dh.data_ptr(), _ptr(dw), n,
            w.shape[0], dm, dh_part.shape[0], float(inv_t), float(log_eps))


def kl_fwd(h, w, tmat, part, kl, lse_s, lse_t, inv_t) -> None:
    """Temperature KL forward (K7) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix at 1/T."""
    n, dm = h.shape
    _aligned(h, w)
    _launch("kdss_kl_fwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(), part.data_ptr(),
            kl.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(), n, w.shape[0], dm, part.shape[1],
            float(inv_t))


def kl_bwd(h, w, tmat, lse_s, lse_t, g, dh_part, dh, dw, inv_t) -> None:
    """Temperature KL backward (K8): dh, and dW unless ``dw`` is None."""
    n, dm = h.shape
    _aligned(h, w, dh, dw)
    _launch("kdss_kl_bwd", h.device, h.data_ptr(), w.data_ptr(), tmat.data_ptr(), lse_s.data_ptr(),
            lse_t.data_ptr(), g.data_ptr(), dh_part.data_ptr(), dh.data_ptr(), _ptr(dw), n,
            w.shape[0], dm, dh_part.shape[0], float(inv_t))


def int8_quantize(x, xq, xs, k_block: int, xla_form: bool) -> None:
    """K12 pass 1: bf16 x [N, K] -> int8 xq [N, K] and the f32 scale of each
    row's K block, xs [N, ceil(K / k_block)]."""
    n, k = x.shape
    _aligned(x, xq)
    _launch("kdss_int8_quantize", x.device, x.data_ptr(), xq.data_ptr(), xs.data_ptr(), n, k,
            int(k_block), int(xla_form))


def int8_gemm(xq, xs, wq, ws, out, k_block: int) -> None:
    """K12 pass 2: out [N, M] (bf16 or f32) from pass 1's xq and xs, the int8
    weight [M, K] and its f32 per-channel scale [M]."""
    n, k = xq.shape
    _aligned(xq, wq, out)
    _launch("kdss_int8_gemm", xq.device, xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            out.data_ptr(), n, k, wq.shape[0], int(k_block), int(out.dtype == torch.float32))


def tmat_int8(h, wq, ws, out, inv_t: float) -> None:
    """K10: the f32 teacher logits out [N, V] at 1/T from bf16 h [N, D] and the
    first V rows of the vocab-major int8 head wq with their scales ws."""
    n, d = h.shape
    _aligned(h, wq, out)
    _launch("kdss_tmat_int8", h.device, h.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, out.shape[1], d, float(inv_t))
