"""Flash-attention forward (port of the JAX package's ``ops/flash_attention.py``).

Public contract, as in the JAX package: BSHD layout, q [B, Sq, Hq, D],
k/v [B, Skv, Hkv, D]; ``mask`` None, [B, Skv] or [B, 1, 1, Skv] (kv padding,
True = attend); ``causal``; ``scale`` (default D**-0.5).

* :func:`flash_attention` is the MHA path (Hq == Hkv; the SigLIP tower).
  Grouped-query shapes dispatch to :func:`flash_attention_gqa`, as the JAX
  function does.
* :func:`flash_attention_gqa` is the grouped-query path (the Qwen2 prefill):
  K/V are read by kv head ``h // G``, never repeated.

Both run one hand-written CUDA kernel (``csrc/flash_fwd.cu``) on a CUDA
tensor, and the plain PyTorch version :func:`flash_attention_ref` on a CPU
tensor (one function for both paths: G = 1 is the MHA case).  On a
CUDA tensor the wrapper launches the kernel or raises; nothing falls back.

Conventions the kernel and the plain versions share:

* causality is aligned to the top left: query row i attends key j iff
  ``i >= j`` (the JAX flash kernels' convention; the Qwen2 prefill passes
  the whole fresh cache, so Skv = S + max_new_tokens > Sq);
* a row with no valid key (every key masked) outputs zeros;
* the softmax is an exact online softmax in float32.  The TPU kernels'
  scalar-shift "bound" mode, its NaN poison, the D -> 128 padding and the
  packed-pair layout are TPU scheduling choices and are not carried over.

Each wrapper carries ``launches``, a plain integer count of kernel launches
(CPU calls never count).  A call that enters through :func:`flash_attention`
with grouped-query shapes counts once, on ``flash_attention_gqa.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

# Head dims the kernel is instantiated for: SigLIP (72) and the Qwen2
# student (64).
KERNEL_HEAD_DIMS = (64, 72)


def _kv_mask(mask: Optional[torch.Tensor], b: int, skv: int) -> Optional[torch.Tensor]:
    """[B, Skv] / [B, 1, 1, Skv] kv-padding mask -> bool [B, Skv] (or None)."""
    if mask is None:
        return None
    if mask.ndim == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(
                "flash attention supports kv-padding masks only; got shape "
                f"{tuple(mask.shape)}"
            )
        mask = mask[:, 0, 0, :]
    elif mask.ndim != 2:
        raise ValueError(f"unsupported mask ndim {mask.ndim}")
    return mask.to(torch.bool).expand(b, skv)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: full float32 probabilities.

    kv_mask: bool [B, Skv] or None.  Returns q.dtype [B, Sq, Hq, D].
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    keep = torch.ones(b, 1, 1, sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        keep = keep & (qpos >= kpos)
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, None, :]
    logits = logits.masked_fill(~keep, float("-inf"))
    has_key = keep.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits.masked_fill(~has_key, 0.0), dim=-1)
    probs = probs * has_key  # rows with no valid key output zeros
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def kernel_args(q, k, v, kv_mask):
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
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled (kernel has {KERNEL_HEAD_DIMS})")
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
    return kv_mask


def _dispatch(q, k, v, mask, causal, scale, counter_owner):
    """Plain version for a CPU tensor; the kernel (or an error) otherwise."""
    b, _, _, d = q.shape
    scale = d**-0.5 if scale is None else float(scale)
    kv_mask = _kv_mask(mask, b, k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_mask, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask_u8 = kernel_args(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors, got {q.device}")
    from ._build import flash_fwd

    out = torch.empty_like(q)
    flash_fwd(q, k, v, mask_u8, out, causal, scale)
    counter_owner.launches += 1
    return out


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
    return _dispatch(q, k, v, mask, causal, scale, flash_attention)


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
    return _dispatch(q, k, v, mask, causal, scale, flash_attention_gqa)


flash_attention.launches = 0
flash_attention_gqa.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention_gqa.launches = 0
