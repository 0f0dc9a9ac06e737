"""Flash attention, forward and backward (port of the JAX package's
``ops/flash_attention.py``).

Public contract, as in the JAX package: BSHD layout, q [B, Sq, Hq, D],
k/v [B, Skv, Hkv, D]; ``mask`` None, [B, Skv] or [B, 1, 1, Skv] (kv padding,
True = attend); ``causal``; ``scale`` (default D**-0.5).

* :func:`flash_attention` is the MHA path (Hq == Hkv; the SigLIP tower).
  Grouped-query shapes dispatch to :func:`flash_attention_gqa`, as the JAX
  function does.
* :func:`flash_attention_gqa` is the grouped-query path (the Qwen2 prefill):
  K/V are read by kv head ``h // G``, never repeated.

Both run a hand-written CUDA kernel on a CUDA tensor (the C entry of
``csrc/flash_fwd.cu`` routes the head dims), each a persistent wgmma kernel
fed by TMA under mbarriers: D = 72, SigLIP's, ``csrc/flash_fwd_sm90.cu``;
D = 64 and 128, the Qwen2 prefills, ``csrc/flash_gqa_sm90.cuh`` (whose
blocks :data:`GQA_SHAPES` states, and whose TMA maps
:func:`tma_head_map`).  A CPU tensor takes the plain PyTorch
version :func:`flash_attention_ref` (one function for both paths: G = 1 is
the MHA case).  On a CUDA tensor the wrapper launches the kernel or raises;
nothing falls back.

Gradients: when autograd needs them, the CUDA forward also writes the row
logsumexp (lse) and a ``torch.autograd.Function`` runs the backward kernels
(the C entry of ``csrc/flash_bwd.cu``: at D = 72 the wgmma kernels of
``csrc/flash_bwd_d72_sm90.cu``, which sum a GQA group in-block and take no
workspace; at D = 64 those of ``csrc/flash_bwd_sm90.cu``, which take an f32
workspace of per-head dk/dv partials, :func:`bwd_workspace_shape`) through
:func:`flash_attention_bwd` (MHA, the JAX ``_flash_vjp_bwd``) or
:func:`flash_attention_gqa_bwd` (grouped-query, the JAX
``_flash_gqa_vjp_bwd``).  Their plain version is
:func:`flash_attention_bwd_ref`, which recomputes P from the same lse.  On
the CPU, gradients flow through :func:`flash_attention_ref` under autograd.

Conventions the kernel and the plain versions share:

* causality is aligned to the top left: query row i attends key j iff
  ``i >= j`` (the JAX flash kernels' convention; the Qwen2 prefill passes
  the whole fresh cache, so Skv = S + max_new_tokens > Sq);
* a row with no valid key (every key masked) outputs zeros;
* the softmax is an exact online softmax in float32.  The TPU kernels'
  scalar-shift "bound" mode, its NaN poison, the D -> 128 padding and the
  packed-pair layout are TPU scheduling choices and are not carried over.

Remat: under the ``flash`` policy of ``models/remat.py`` a
:class:`FlashSaveCache` is active while a layer runs.  The first pass keeps
each forward's ``out`` and ``lse`` there; the recompute in the backward
takes them back instead of running the forward again (on a CPU tensor the
plain forward then runs through the same ``torch.autograd.Function``, its
backward the plain :func:`flash_attention_bwd_ref`).  ``flash_attention_ref``
counts its calls in ``flash_attention_ref.calls``.

Each wrapper carries ``launches``, a plain integer count of kernel launches
(CPU calls never count), and ``head_dim_launches``, the same count split by
head dim (the GQA forward runs at D = 64 for the student and D = 128 for the
7B teacher).  A call that enters through :func:`flash_attention` with
grouped-query shapes counts once, on ``flash_attention_gqa``; its backward
counts on ``flash_attention_gqa_bwd``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# Head dims the kernels are instantiated for: SigLIP (72) and the Qwen2
# student (64) forward and backward; the 7B teacher's Qwen2 (128) forward
# only (the teacher is frozen).
KERNEL_HEAD_DIMS = (64, 72, 128)
BWD_HEAD_DIMS = (64, 72)
# The head dim whose backward runs the wgmma kernels (csrc/flash_bwd_sm90.cu).
WGMMA_BWD_HEAD_DIM = 64
# The block of the D = 64 / 128 forward (csrc/flash_gqa_sm90.cuh, Shape<D>):
# head dim -> (consumer warpgroups of 64 q rows, kv tile rows, K/V stages).
GQA_SHAPES = {64: (3, 64, 4), 128: (2, 128, 2)}
# TMA's limits on a tiled map (CUDA driver API, cuTensorMapEncodeTiled).
TMA_MAX_BOX = 256
TMA_SWIZZLE_BYTES = 128


def tma_head_map(shape, rows: int) -> dict:
    """The tensor map the flash kernels load a bf16 BSHD tensor [B, S, H, D]
    through (``tma_head_map`` / ``head_map`` in ``csrc/flash_gqa_sm90.cuh``
    and ``csrc/flash_d72_sm90.cuh``): dims {D, H, S, B} innermost first, the
    byte strides of dims 1-3, a box of 64 columns (128 bytes, the swizzle
    span) x ``rows`` rows of one head, and the boxes a row takes (columns
    past D zero-filled).  Raises ValueError for a map TMA cannot encode."""
    b, s, h, d = (int(x) for x in shape)
    row = 2 * d
    strides = (row, row * h, row * h * s)
    box = (64, 1, int(rows), 1)
    if any(x % 16 for x in strides):
        raise ValueError(f"TMA needs 16-byte strides: head dim {d} gives {strides}")
    if not 0 < rows <= TMA_MAX_BOX:
        raise ValueError(f"a TMA box takes 1-{TMA_MAX_BOX} rows, got {rows}")
    if any(not 0 < x < 2**32 for x in (d, h, s, b)) or strides[-1] >= 2**40:
        raise ValueError(f"a TMA map takes dims below 2^32 and strides below 2^40, got {tuple(shape)}")
    return dict(dims=(d, h, s, b), strides=strides, box=box, boxes=-(-d // 64),
                box_bytes=box[0] * 2 * rows)


def gqa_tiles(b: int, sq: int, hq: int, d: int) -> int:
    """The (q tile, q head, batch) tiles of the D = 64 / 128 forward: what its
    persistent blocks walk, longest first under causality."""
    return -(-sq // (64 * GQA_SHAPES[d][0])) * hq * b


def bwd_workspace_shape(q_shape, k_shape):
    """The f32 workspace of the backward kernels: per-head dk and dv partials
    [2, G, B, Skv, Hkv, D] at D = 64, which the kernel sums over the G query
    heads of each kv head in a fixed order; None at other head dims (the
    D = 72 kernels sum a group inside the block that owns the kv rows)."""
    b, _, hq, d = q_shape
    skv, hkv = k_shape[1], k_shape[2]
    if d != WGMMA_BWD_HEAD_DIM:
        return None
    return (2, hq // hkv, b, skv, hkv, d)


def _kv_mask(mask: Optional[torch.Tensor], b: int, skv: int) -> Optional[torch.Tensor]:
    """[B, Skv] / [B, 1, 1, Skv] kv-padding mask -> bool [B, Skv] (or None);
    also the mask of ``ops/attention.py``'s ``xla_chunked`` arm."""
    if mask is None:
        return None
    if mask.ndim == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(
                "flash and chunked attention take kv-padding masks only; got shape "
                f"{tuple(mask.shape)}"
            )
        mask = mask[:, 0, 0, :]
    elif mask.ndim != 2:
        raise ValueError(f"unsupported mask ndim {mask.ndim}")
    return mask.to(torch.bool).expand(b, skv)


def _keep(b, sq, skv, kv_mask, causal, device) -> torch.Tensor:
    """bool [B, 1, 1, Sq, Skv]: which (query, key) pairs attend."""
    keep = torch.ones(b, 1, 1, sq, skv, dtype=torch.bool, device=device)
    if causal:
        qpos = torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(skv, device=device)[None, :]
        keep = keep & (qpos >= kpos)
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, None, :]
    return keep


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain PyTorch version of the forward kernel: full float32 probabilities.

    kv_mask: bool [B, Skv] or None.  Returns q.dtype [B, Sq, Hq, D], and with
    ``return_lse`` also the f32 row logsumexp [B, Hq, Sq] of the scaled
    scores (-inf for a row with no valid key), as the kernel writes it.
    """
    flash_attention_ref.calls += 1
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    keep = _keep(b, sq, skv, kv_mask, causal, q.device)
    logits = logits.masked_fill(~keep, float("-inf"))
    has_key = keep.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits.masked_fill(~has_key, 0.0), dim=-1)
    probs = probs * has_key  # rows with no valid key output zeros
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)


# The JAX backward's clamp for dead rows (`_neutralize_dead_rows`): +0.7 of
# the f32 maximum, so exp(s - lse) underflows to exactly 0 for any score.
_DEAD_LSE = 0.7 * torch.finfo(torch.float32).max


def neutralize_dead_rows(lse: torch.Tensor, delta: torch.Tensor):
    """Rows with no valid key (lse == -inf) get lse = +huge and delta = 0, so
    their P and dS are exactly 0 in the backward, with no row guard in the
    kernel (JAX ``_neutralize_dead_rows``)."""
    dead = torch.isneginf(lse)
    return lse.masked_fill(dead, _DEAD_LSE), delta.masked_fill(dead, 0.0)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, [B, Sq, Hq, D] -> [B, Hq, Sq] (computed outside
    the kernel, as the JAX backward does)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, kv_mask, causal, scale, lse, delta, dout):
    """Plain PyTorch version of the backward kernels (K2/K4): dq, dk, dv from
    the saved lse and delta = rowsum(dO * O) (both already neutralized),
    f32 math, with P rounded to dout's dtype before P^T dO and dS rounded to
    q's dtype before dS K and dS^T Q, as the kernels (and the JAX kernels)
    do.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, hkv, g, d)
    dog = dout.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    keep = _keep(b, sq, skv, kv_mask, causal, q.device)
    lse5 = lse.reshape(b, hkv, g, sq, 1)
    p = torch.exp(s - lse5).masked_fill(~keep, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = (p * (dp - delta.reshape(b, hkv, g, sq, 1)) * scale).to(q.dtype).float()
    p = p.to(dout.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_args(q, k, v, kv_mask, head_dims=KERNEL_HEAD_DIMS):
    """Check what the kernel takes; raise ValueError on anything else.

    Device-independent, so the CPU tests reach it.  Returns the mask as a
    contiguous uint8 view (or None).
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be BSHD (4-d)")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if d not in head_dims:
        raise ValueError(f"head dim {d} not compiled (kernel has {head_dims})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kv_mask is not None:
        if kv_mask.shape != (b, k.shape[1]) or kv_mask.dtype != torch.bool:
            raise ValueError("kv_mask must be bool [B, Skv]")
        kv_mask = kv_mask.contiguous().view(torch.uint8)
    if b > 65535 or hq > 65535:
        raise ValueError(f"the kernels take B and Hq up to 65535, got {b} and {hq}")
    if d in GQA_SHAPES:
        wgs, bk, _ = GQA_SHAPES[d]
        tma_head_map(q.shape, 64 * wgs)
        tma_head_map(k.shape, bk)
        if gqa_tiles(b, sq, hq, d) > 2**30:
            raise ValueError(f"{gqa_tiles(b, sq, hq, d)} q tiles: the tile counter takes at most 2^30")
    return kv_mask


class FlashSaveCache:
    """What the ``flash`` remat policy keeps of one layer's first pass: the
    ``(out, lse)`` of each flash forward, in call order.  While the cache is
    active (:func:`save_flash_outputs`), the first pass appends to it; once
    ``replay`` is set, the recompute takes the same forwards' results back
    in the same order and launches nothing."""

    def __init__(self):
        self.saved = []
        self.replay = False

    def keep(self, out: torch.Tensor, lse: torch.Tensor) -> None:
        self.saved.append((out.detach(), lse))

    def take(self):
        if not self.saved:
            raise RuntimeError("the recompute ran more flash forwards than the first pass")
        return self.saved.pop(0)


_ACTIVE_CACHE = [None]


@contextlib.contextmanager
def save_flash_outputs(cache: FlashSaveCache):
    """Make ``cache`` the one the flash forwards keep to (or take from)."""
    prev, _ACTIVE_CACHE[0] = _ACTIVE_CACHE[0], cache
    try:
        yield cache
    finally:
        _ACTIVE_CACHE[0] = prev


class _FlashFn(torch.autograd.Function):
    """Forward that saves the lse (the kernel on CUDA; the plain version on
    the CPU, only under a :class:`FlashSaveCache`), backward from it; under
    a replaying cache the forward's results come from the cache."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, mask_u8, causal, scale, fwd_owner, bwd_owner, cache):
        if cache is not None and cache.replay:
            out, lse = cache.take()
        elif q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, kv_mask, causal, scale, return_lse=True)
        else:
            from ._build import flash_fwd

            b, sq, hq, _ = q.shape
            out = torch.empty_like(q)
            lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
            flash_fwd(q, k, v, mask_u8, out, lse, causal, scale)
            _count(fwd_owner, q.shape[3])
        if cache is not None and not cache.replay:
            cache.keep(out, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_mask, ctx.causal, ctx.scale, ctx.bwd_owner = kv_mask, causal, scale, bwd_owner
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(out, dout)
        dq, dk, dv = ctx.bwd_owner(q, k, v, dout.contiguous(), lse, delta,
                                   mask=ctx.kv_mask, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def _dispatch(q, k, v, mask, causal, scale, fwd_owner, bwd_owner):
    """Plain version for a CPU tensor; the kernel (or an error) otherwise."""
    b, _, _, d = q.shape
    scale = d**-0.5 if scale is None else float(scale)
    kv_mask = _kv_mask(mask, b, k.shape[1])
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    cache = _ACTIVE_CACHE[0] if grad else None
    if q.device.type == "cpu":
        if cache is not None:
            return _FlashFn.apply(q, k, v, kv_mask, None, causal, scale, fwd_owner, bwd_owner, cache)
        return flash_attention_ref(q, k, v, kv_mask, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask_u8 = kernel_args(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors, got {q.device}")
    if grad:
        kernel_args(q, k, v, kv_mask, BWD_HEAD_DIMS)  # the backward must exist
        return _FlashFn.apply(q, k, v, kv_mask, mask_u8, causal, scale, fwd_owner, bwd_owner, cache)
    from ._build import flash_fwd

    out = torch.empty_like(q)
    flash_fwd(q, k, v, mask_u8, out, None, causal, scale)  # no lse without a backward
    _count(fwd_owner, q.shape[3])
    return out


def _bwd_dispatch(q, k, v, dout, lse, delta, mask, causal, scale, counter_owner):
    """Backward from the saved lse: the plain version on a CPU tensor, the
    kernel (or an error) otherwise.  Neutralizes dead rows first."""
    b, _, _, d = q.shape
    scale = d**-0.5 if scale is None else float(scale)
    kv_mask = _kv_mask(mask, b, k.shape[1])
    lse, delta = neutralize_dead_rows(lse.float(), delta.float())
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, kv_mask, causal, scale, lse, delta, dout)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    mask_u8 = kernel_args(q, k, v, kv_mask, BWD_HEAD_DIMS)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors, got {q.device}")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q: {tuple(dout.shape)} {dout.dtype}")
    b, sq, hq, _ = q.shape
    if lse.shape != (b, hq, sq) or delta.shape != (b, hq, sq):
        raise ValueError("lse and delta must be f32 [B, Hq, Sq]")
    from ._build import flash_bwd

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws_shape = bwd_workspace_shape(q.shape, k.shape)
    part = None if ws_shape is None else torch.empty(ws_shape, dtype=torch.float32, device=q.device)
    flash_bwd(q, k, v, mask_u8, dout, lse.contiguous(), delta.contiguous(), dq, dk, dv,
              causal, scale, part)
    _count(counter_owner, q.shape[3])
    return dq, dk, dv


def flash_attention_bwd(q, k, v, dout, lse, delta, *, mask=None, causal=False, scale=None):
    """MHA backward (K2): (dq, dk, dv) from the forward's lse [B, Hq, Sq] and
    delta = rowsum(dO * O) [B, Hq, Sq]; same mask/causal/scale contract as
    :func:`flash_attention`.  Grouped-query shapes dispatch to
    :func:`flash_attention_gqa_bwd` (and count there)."""
    if q.shape[2] != k.shape[2]:
        return flash_attention_gqa_bwd(q, k, v, dout, lse, delta, mask=mask, causal=causal,
                                       scale=scale)
    return _bwd_dispatch(q, k, v, dout, lse, delta, mask, causal, scale, flash_attention_bwd)


def flash_attention_gqa_bwd(q, k, v, dout, lse, delta, *, mask=None, causal=False, scale=None):
    """Grouped-query backward (K4): dk and dv are summed over each kv head's
    query heads inside the kernel."""
    return _bwd_dispatch(q, k, v, dout, lse, delta, mask, causal, scale, flash_attention_gqa_bwd)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """BSHD flash attention, MHA path.  Grouped-query shapes dispatch to
    :func:`flash_attention_gqa` (and count there)."""
    if q.shape[2] != k.shape[2]:
        return flash_attention_gqa(q, k, v, mask=mask, causal=causal, scale=scale)
    return _dispatch(q, k, v, mask, causal, scale, flash_attention, flash_attention_bwd)


def flash_attention_gqa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query variant of :func:`flash_attention` (same contract)."""
    return _dispatch(q, k, v, mask, causal, scale, flash_attention_gqa, flash_attention_gqa_bwd)


WRAPPERS = (flash_attention, flash_attention_gqa, flash_attention_bwd, flash_attention_gqa_bwd)


def _count(owner, head_dim: int) -> None:
    owner.launches += 1
    owner.head_dim_launches[head_dim] = owner.head_dim_launches.get(head_dim, 0) + 1


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.head_dim_launches = {}
    flash_attention_ref.calls = 0


reset_launch_counts()
