"""Attention primitives (port of the JAX package's ``ops/attention.py``).

Shapes follow the BSHD convention: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D],
with grouped-query broadcast when Hq > Hkv.  ``impl="xla"`` is the plain
full-probability path (the name keeps the JAX package's meaning);
``impl="flash"`` is the flash-attention kernel arm (the JAX ``"pallas"``).
"""

from __future__ import annotations

from typing import Optional

import torch


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
    ``"flash"`` arm takes kv-padding masks only: [B, Skv] or [B, 1, 1, Skv]).
    The softmax accumulates in float32 whatever the input dtype.  On the
    ``"xla"`` path causality is aligned to the bottom right
    (``tril(k=Skv-Sq)``), as in the JAX package; the flash arm aligns it to
    the top left (see ``ops/flash_attention.py``).
    """
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (use 'xla' or 'flash')")

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
