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
modules (``flash_attention``, ``flash_phase_ablation``, ``fused_ce``,
``fused_loca``, ``fused_kl``, ``int8``);
pointers stay alive until the kernels end because the callers hold the
tensors and the launches are ordered on the current stream with their
later use.  Under ``FakeTensorMode`` a launcher returns before it reads a
pointer (:func:`_traceable`): the memory planner traces the kernel routes.
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
from torch._subclasses.fake_tensor import FakeTensor

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
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    signatures = {
        # q, k, v, kv_mask, out, lse, next_tile, B, Sq, Skv, Hq, Hkv, D, causal, scale, stream
        "kdss_flash_fwd": [vp] * 7 + [ci] * 7 + [cf, vp],
        # q, k, v, out, next_tile, shift, B, S, Hq, Hkv, D, arm, scale, stream
        "kdss_flash_phase_ablation": [vp] * 6 + [ci] * 6 + [cf, vp],
        # q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, part, B, Sq, Skv, Hq, Hkv, D, causal,
        # scale, stream
        "kdss_flash_bwd": [vp] * 11 + [ci] * 7 + [cf, vp],
        # h, w, labels, lse_part, gold_part, lse, gold, N, V, DM, nsplit, stream
        "kdss_ce_fwd": [vp] * 7 + [ci] * 4 + [vp],
        # h, w, labels, lse, g_lse, g_gold, ds, dh_part, dh, dw, N, V, DM, ld_ds, nsplit_ds,
        # nsplit_dh, stream
        "kdss_ce_bwd": [vp] * 10 + [ci] * 3 + [cl] + [ci] * 2 + [vp],
        # h, w, tmat, lab, lab_ce, part, rowstats, kl, ce, N, V, DM, nsplit,
        # inv_t, alpha, log_eps, stream
        "kdss_loca_ce_fwd": [vp] * 9 + [ci] * 4 + [cf] * 3 + [vp],
        # h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, ds, dh_part, dh, dw, N, V, DM,
        # ld_ds, nsplit_ds, nsplit_dh, inv_t, log_eps, stream
        "kdss_loca_ce_bwd": [vp] * 12 + [ci] * 3 + [cl] + [ci] * 2 + [cf] * 2 + [vp],
        # h, w, tmat, lab, part, rowstats, kl, N, V, DM, nsplit, inv_t, alpha,
        # log_eps, stream
        "kdss_loca_fwd": [vp] * 7 + [ci] * 4 + [cf] * 3 + [vp],
        # h, w, tmat, lab, rowstats, g, ds, dh_part, dh, dw (or null), N, V, DM,
        # ld_ds, nsplit_ds, nsplit_dh, inv_t, log_eps, stream
        "kdss_loca_bwd": [vp] * 10 + [ci] * 3 + [cl] + [ci] * 2 + [cf] * 2 + [vp],
        # h, w, tmat, part, kl, lse_s, lse_t, N, V, DM, nsplit, inv_t, stream
        "kdss_kl_fwd": [vp] * 7 + [ci] * 4 + [cf, vp],
        # h, w, tmat, lse_s, lse_t, g, ds, dh_part, dh, dw (or null), N, V, DM, ld_ds,
        # nsplit_ds, nsplit_dh, inv_t, stream
        "kdss_kl_bwd": [vp] * 10 + [ci] * 3 + [cl] + [ci] * 2 + [cf, vp],
        # x, xq, xs, N, K, k_block, div_scale, stream
        "kdss_int8_quantize": [vp] * 3 + [ci] * 4 + [vp],
        # xq, xs, wq, ws, out, N, K, M, k_block, out_f32, stream
        "kdss_int8_gemm": [vp] * 5 + [ci] * 5 + [vp],
        # the split form: x, amax, N, K, stream
        "kdss_int8_absmax": [vp] * 2 + [ci] * 2 + [vp],
        # x, amax, xq, xs, N, K, stream
        "kdss_int8_quantize_given": [vp] * 4 + [ci] * 2 + [vp],
        # xq, wq, acc, N, K, M, stream
        "kdss_int8_gemm_s32": [vp] * 3 + [ci] * 3 + [vp],
        # acc, xs, ws, out, N, M, out_f32, stream
        "kdss_int8_epilogue": [vp] * 4 + [ci] * 3 + [vp],
        # hp, wq, ws, out, N, V, D, Dp, inv_t, stream
        "kdss_tmat_int8": [vp] * 4 + [ci] * 4 + [cf, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    lib.kdss_cuda_error_string.argtypes = [ci]
    lib.kdss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    """The device address of ``t`` (None for None).  A DTensor is refused:
    its ``data_ptr`` is not the address of the shard a kernel should read,
    so a caller under a mesh hands each kernel ``.to_local()`` tensors."""
    if t is None:
        return None
    if is_dtensor(t):
        raise TypeError("a kernel takes local tensors: pass DTensor.to_local(), not the DTensor")
    return t.data_ptr()


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed`` DTensor."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(t, DTensor)


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
        if t is not None and _ptr(t) % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _tile_counter(device):
    """One int32 of device memory: the persistent flash kernels' tile
    counter, which the launch sets to 0 on the stream."""
    return torch.empty(1, dtype=torch.int32, device=device)


def _traceable(launcher=None, *, scratch=None):
    """Make ``launcher`` return at once when its first operand is a
    ``FakeTensor`` (a step traced under ``FakeTensorMode``, as
    ``parallel/aot.py`` traces one): before ``_aligned``, ``_ptr`` or
    :func:`load_library`, none of which a tensor without storage can serve.
    The op modules allocate every output and scratch buffer before the
    launch, and ``scratch(device)`` is what the launcher allocates for
    itself (the flash kernels' tile counter), which a traced call allocates
    too; so a traced step allocates what the real step allocates and
    computes nothing.  A real tensor always goes on to the launch."""
    if launcher is None:
        return functools.partial(_traceable, scratch=scratch)

    @functools.wraps(launcher)
    def launch(*args, **kwargs):
        if isinstance(args[0], FakeTensor):
            if scratch is not None:
                scratch(args[0].device)
            return None
        return launcher(*args, **kwargs)

    return launch


@_traceable(scratch=_tile_counter)
def flash_fwd(q, k, v, kv_mask_u8, out, lse, causal: bool, scale: float) -> None:
    """Flash forward (K1/K3); ``lse`` f32 [B, Hq, Sq] or None."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _aligned(q, k, v, out)
    _launch("kdss_flash_fwd", q.device, _ptr(q), _ptr(k), _ptr(v),
            _ptr(kv_mask_u8), _ptr(out), _ptr(lse), _ptr(_tile_counter(q.device)),
            b, sq, skv, hq, hkv, d, int(causal), float(scale))


@_traceable(scratch=_tile_counter)
def flash_phase_ablation(q, k, v, out, shift, arm: int, scale: float) -> None:
    """K13: phase-ablation arm ``arm`` (an index into
    ``flash_phase_ablation.ARMS``) of the causal flash forward, Sq == Skv, no
    mask; ``shift`` f32 [1] on the card (the streaming_smem arm's c) or None."""
    b, s, hq, d = q.shape
    _aligned(q, k, v, out)
    _launch("kdss_flash_phase_ablation", q.device, _ptr(q), _ptr(k), _ptr(v),
            _ptr(out), _ptr(_tile_counter(q.device)), _ptr(shift), b, s, hq, k.shape[2], d,
            int(arm), float(scale))


@_traceable
def flash_bwd(q, k, v, kv_mask_u8, dout, lse, delta, dq, dk, dv, causal: bool,
              scale: float, part=None) -> None:
    """Flash backward (K2/K4): dq, dk, dv from the saved lse and delta;
    ``part`` the f32 workspace at D = 64
    (``flash_attention.bwd_workspace_shape``), None at D = 72."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _aligned(q, k, v, dout, dq, dk, dv, part)
    _launch("kdss_flash_bwd", q.device, _ptr(q), _ptr(k), _ptr(v),
            _ptr(kv_mask_u8), _ptr(dout), _ptr(lse), _ptr(delta),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(part),
            b, sq, skv, hq, hkv, d, int(causal), float(scale))


@_traceable
def ce_fwd(h, w, labels, lse_part, gold_part, lse, gold) -> None:
    """Fused CE forward (K5) over a [V, DM] head: a sweep whose partials
    ``lse_part`` and ``gold_part`` [nsplit, N] (two per vocab split of the
    sweep) are combined into ``lse`` and ``gold``."""
    n, dm = h.shape
    _aligned(h, w)
    _launch("kdss_ce_fwd", h.device, _ptr(h), _ptr(w), _ptr(labels),
            _ptr(lse_part), _ptr(gold_part), _ptr(lse), _ptr(gold),
            n, w.shape[0], dm, lse_part.shape[0])


@_traceable
def ce_bwd(h, w, labels, lse, g_lse, g_gold, ds, dh_part, dh, dw, nsplit_ds: int) -> None:
    """Fused CE backward (K6) over a [V, DM] head: the bf16 d_logits into
    ``ds`` [N, ld_ds] (a sweep of ``nsplit_ds`` vocab splits), then dh
    through the f32 partials ``dh_part`` [nsplit_dh, N, DM], and dW."""
    n, dm = h.shape
    _aligned(h, w, ds, dh, dw)
    _launch("kdss_ce_bwd", h.device, _ptr(h), _ptr(w), _ptr(labels),
            _ptr(lse), _ptr(g_lse), _ptr(g_gold), _ptr(ds), _ptr(dh_part),
            _ptr(dh), _ptr(dw), n, w.shape[0], dm, ds.shape[1], int(nsplit_ds), dh_part.shape[0])


@_traceable
def loca_ce_fwd(h, w, tmat, lab, lab_ce, part, rowstats, kl, ce, inv_t, alpha, log_eps) -> None:
    """Combined LoCa + CE forward (K11) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix."""
    n, dm = h.shape
    _aligned(h, w, tmat)
    _launch("kdss_loca_ce_fwd", h.device, _ptr(h), _ptr(w), _ptr(tmat),
            _ptr(lab), _ptr(lab_ce), _ptr(part), _ptr(rowstats),
            _ptr(kl), _ptr(ce), n, w.shape[0], dm, part.shape[1],
            float(inv_t), float(alpha), float(log_eps))


@_traceable
def loca_ce_bwd(h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, ds, dh_part, dh, dw, nsplit_ds: int,
                inv_t, log_eps) -> None:
    """Combined LoCa + CE backward (K11): the bf16 d_logits into ``ds`` [N,
    ld_ds] (a sweep of ``nsplit_ds`` vocab splits), then dh through the f32
    partials ``dh_part`` [nsplit_dh, N, DM], and dW."""
    n, dm = h.shape
    _aligned(h, w, tmat, ds, dh, dw)
    _launch("kdss_loca_ce_bwd", h.device, _ptr(h), _ptr(w), _ptr(tmat),
            _ptr(lab), _ptr(lab_ce), _ptr(rowstats), _ptr(g_kl),
            _ptr(g_ce), _ptr(ds), _ptr(dh_part), _ptr(dh), _ptr(dw), n,
            w.shape[0], dm, ds.shape[1], int(nsplit_ds), dh_part.shape[0], float(inv_t), float(log_eps))


@_traceable
def loca_fwd(h, w, tmat, lab, part, rowstats, kl, inv_t, alpha, log_eps) -> None:
    """LoCa forward without CE (K9) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix."""
    n, dm = h.shape
    _aligned(h, w, tmat)
    _launch("kdss_loca_fwd", h.device, _ptr(h), _ptr(w), _ptr(tmat), _ptr(lab),
            _ptr(part), _ptr(rowstats), _ptr(kl), n, w.shape[0], dm, part.shape[1],
            float(inv_t), float(alpha), float(log_eps))


@_traceable
def loca_bwd(h, w, tmat, lab, rowstats, g, ds, dh_part, dh, dw, nsplit_ds: int, inv_t, log_eps) -> None:
    """LoCa backward without CE (K9): as :func:`loca_ce_bwd`, dW unless
    ``dw`` is None."""
    n, dm = h.shape
    _aligned(h, w, tmat, ds, dh, dw)
    _launch("kdss_loca_bwd", h.device, _ptr(h), _ptr(w), _ptr(tmat), _ptr(lab),
            _ptr(rowstats), _ptr(g), _ptr(ds), _ptr(dh_part), _ptr(dh), _ptr(dw),
            n, w.shape[0], dm, ds.shape[1], int(nsplit_ds), dh_part.shape[0], float(inv_t),
            float(log_eps))


@_traceable
def kl_fwd(h, w, tmat, part, kl, lse_s, lse_t, inv_t) -> None:
    """Temperature KL forward (K7) over a [V, DM] head and an f32 [N, V]
    teacher-logit matrix at 1/T: a sweep whose partials ``part`` [6,
    nsplit, N] (two per vocab split of the sweep) are combined into ``kl``,
    ``lse_s`` and ``lse_t``."""
    n, dm = h.shape
    _aligned(h, w, tmat)
    _launch("kdss_kl_fwd", h.device, _ptr(h), _ptr(w), _ptr(tmat), _ptr(part),
            _ptr(kl), _ptr(lse_s), _ptr(lse_t), n, w.shape[0], dm, part.shape[1],
            float(inv_t))


@_traceable
def kl_bwd(h, w, tmat, lse_s, lse_t, g, ds, dh_part, dh, dw, nsplit_ds: int, inv_t) -> None:
    """Temperature KL backward (K8): as :func:`ce_bwd` with the f32 [N, V]
    teacher-logit matrix at 1/T, dW unless ``dw`` is None."""
    n, dm = h.shape
    _aligned(h, w, tmat, ds, dh, dw)
    _launch("kdss_kl_bwd", h.device, _ptr(h), _ptr(w), _ptr(tmat), _ptr(lse_s),
            _ptr(lse_t), _ptr(g), _ptr(ds), _ptr(dh_part), _ptr(dh), _ptr(dw), n,
            w.shape[0], dm, ds.shape[1], int(nsplit_ds), dh_part.shape[0], float(inv_t))


@_traceable
def int8_quantize(x, xq, xs, k_block: int, xla_form: bool) -> None:
    """K12 pass 1: bf16 x [N, K] -> int8 xq [N, K] and the f32 scale of each
    row's K block, xs [N, ceil(K / k_block)]."""
    n, k = x.shape
    _aligned(x, xq)
    _launch("kdss_int8_quantize", x.device, _ptr(x), _ptr(xq), _ptr(xs), n, k,
            int(k_block), int(xla_form))


@_traceable
def int8_gemm(xq, xs, wq, ws, out, k_block: int) -> None:
    """K12 pass 2: out [N, M] (bf16 or f32) from pass 1's xq and xs, the int8
    weight [M, K] and its f32 per-channel scale [M]."""
    n, k = xq.shape
    _aligned(xq, wq, out)
    _launch("kdss_int8_gemm", xq.device, _ptr(xq), _ptr(xs), _ptr(wq), _ptr(ws),
            _ptr(out), n, k, wq.shape[0], int(k_block), int(out.dtype == torch.float32))


@_traceable
def int8_absmax(x, amax) -> None:
    """K12's split form, the row-absmax pass: max |x| of each row of bf16 x
    [N, K] into f32 ``amax`` [N], unclamped."""
    n, k = x.shape
    _aligned(x)
    _launch("kdss_int8_absmax", x.device, _ptr(x), _ptr(amax), n, k)


@_traceable
def int8_quantize_given(x, amax, xq, xs) -> None:
    """K12's split form, the quantize pass with a given row amax f32 [N]
    (clamped to 1e-6 in the kernel): int8 xq [N, K] and xs = amax / 127, f32
    [N]."""
    n, k = x.shape
    _aligned(x, xq)
    _launch("kdss_int8_quantize_given", x.device, _ptr(x), _ptr(amax), _ptr(xq), _ptr(xs), n, k)


@_traceable
def int8_gemm_s32(xq, wq, acc) -> None:
    """K12's split form, the GEMM with an int32 output: the raw sums
    xq [N, K] . wq [M, K]^T into ``acc`` int32 [N, M], no epilogue."""
    n, k = xq.shape
    _aligned(xq, wq, acc)
    _launch("kdss_int8_gemm_s32", xq.device, _ptr(xq), _ptr(wq), _ptr(acc), n, k, wq.shape[0])


@_traceable
def int8_epilogue(acc, xs, ws, out) -> None:
    """K12's split form, the scale epilogue: out [N, M] (bf16 or f32) =
    (float(acc) * xs[row]) * ws[col]."""
    n, m = acc.shape
    _aligned(acc, out)
    _launch("kdss_int8_epilogue", acc.device, _ptr(acc), _ptr(xs), _ptr(ws), _ptr(out), n, m,
            int(out.dtype == torch.float32))


@_traceable
def tmat_int8(hp, wq, ws, out, inv_t: float) -> None:
    """K10: the f32 teacher logits out [N, V] at 1/T from the hidden states in
    K10's layout hp [N, Dp] (``fused_loca.k10_hidden_layout``) and the first V
    rows of the vocab-major int8 head wq [V, D] with their scales ws."""
    n, dp = hp.shape
    _aligned(hp, wq, out)
    _launch("kdss_tmat_int8", hp.device, _ptr(hp), _ptr(wq), _ptr(ws), _ptr(out),
            n, out.shape[1], wq.shape[1], dp, float(inv_t))
