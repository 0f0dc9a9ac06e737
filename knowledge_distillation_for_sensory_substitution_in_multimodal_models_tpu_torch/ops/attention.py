"""Attention primitives (port of the JAX package's ``ops/attention.py``).

Shapes follow the BSHD convention: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D],
with grouped-query broadcast when Hq > Hkv.  The impls keep the JAX
package's names:

* ``"xla"``: the plain full-probability path;
* ``"xla_chunked"``: :func:`xla_chunked_attention`, the plain path over
  query chunks, one [B, H, chunk, Skv] block at a time;
* ``"pallas"`` (and its older name ``"flash"``): the flash-attention
  kernels (``ops/flash_attention.py``);
* ``"pallas_spmd"``: the same kernels on a rank's local tensors under a
  mesh (the JAX ``flash_attention_spmd``).  A rank already holds its rows
  of the batch (``parallel/sharding.py::shard_batch``) and, under tensor
  parallelism, its local heads, so the kernel runs on what it is given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

# The impls that run the flash kernels.
FLASH_IMPLS = ("flash", "pallas", "pallas_spmd")
IMPLS = ("xla", "xla_chunked") + FLASH_IMPLS


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _softmax_all_masked_uniform(logits: torch.Tensor) -> torch.Tensor:
    # Rows that are fully masked (padding queries) would produce NaN; give
    # them a uniform distribution instead, as the JAX package does — their
    # outputs are masked downstream anyway.
    all_masked = torch.isneginf(logits).all(dim=-1, keepdim=True)
    logits = logits.masked_fill(all_masked, 0.0)
    return torch.softmax(logits, dim=-1)


def xla_chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Flash attention's memory behavior out of plain PyTorch (the JAX
    ``xla_chunked_attention``): a loop over query chunks, each of which
    holds only a [B, H, chunk, Skv] probability block.  When autograd needs
    it, each chunk runs under a (non-reentrant) checkpoint, so the backward
    recomputes a chunk's block instead of keeping every chunk's.

    q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]; kv_mask bool [B, Skv], True =
    attend.  As in the JAX function: Sq is padded up to a multiple of
    ``chunk`` and the padding sliced off; causality is aligned to the top
    left (query row i attends key j iff i >= j); masked logits take half the
    float32 minimum, not -inf, so a row with no valid key is uniform.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    scale = (d**-0.5) if scale is None else scale
    pad = (-sq) % chunk
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    kf = k.float()
    kpos = torch.arange(skv, device=q.device)
    neg = torch.finfo(torch.float32).min * 0.5
    drop = None if kv_mask is None else ~kv_mask.to(torch.bool)[:, None, None, :]

    def one(qblk: torch.Tensor, start: int) -> torch.Tensor:
        logits = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kf) * scale
        if causal:
            qpos = start + torch.arange(chunk, device=q.device)
            logits = logits.masked_fill(qpos[:, None] < kpos[None, :], neg)
        if drop is not None:
            logits = logits.masked_fill(drop, neg)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for start in range(0, qp.shape[1], chunk):
        qblk = qp[:, start:start + chunk]
        outs.append(checkpoint(one, qblk, start, use_reentrant=False) if remat else one(qblk, start))
    return torch.cat(outs, dim=1)[:, :sq]


def gqa_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Few-token decode attention that contracts the query, reshaped to
    [B, Sq, Hkv, G, D], against the cache directly — K/V are never repeated
    to the query head count.  Plain torch: the JAX reference is XLA here too.

    mask: [B, 1, Sq, Skv] or [B, Sq, Skv] boolean, True = attend.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = (d**-0.5) if scale is None else scale
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 3:
            mask = mask[:, None]
        # [B, 1, Sq, Skv] -> [B, 1, 1, Sq, Skv] over (hkv, g)
        logits = logits.masked_fill(~mask[:, :, None], float("-inf"))
    probs = _softmax_all_masked_uniform(logits).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Multi-head attention with optional GQA, padding mask and causality.

    mask: [B, Sq, Skv] or [B, 1, Sq, Skv] boolean, True = attend (the
    flash and ``"xla_chunked"`` arms take kv-padding masks only: [B, Skv]
    or [B, 1, 1, Skv]).
    The softmax accumulates in float32 whatever the input dtype.  On the
    ``"xla"`` path causality is aligned to the bottom right
    (``tril(k=Skv-Sq)``), as in the JAX package; the flash arm aligns it to
    the top left (see ``ops/flash_attention.py``).
    """
    if impl in FLASH_IMPLS:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    if impl == "xla_chunked":
        from .flash_attention import _kv_mask

        return xla_chunked_attention(q, k, v, kv_mask=_kv_mask(mask, q.shape[0], k.shape[1]), causal=causal,
                                     scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (use one of {IMPLS})")

    sq, hq, d = q.shape[1:]
    hkv = k.shape[2]
    if hq != hkv:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    scale = (d**-0.5) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    skv = k.shape[1]
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.ndim == 3:
            mask = mask[:, None]
        logits = logits.masked_fill(~mask, float("-inf"))

    probs = _softmax_all_masked_uniform(logits).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
