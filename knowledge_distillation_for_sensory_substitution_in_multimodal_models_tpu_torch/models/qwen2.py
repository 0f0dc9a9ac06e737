"""Qwen2 decoder-only LM (port of the JAX package's ``models/qwen2.py``).

RMSNorm pre-norm blocks, biased QKV and a bias-free output projection, GQA,
NeoX-style RoPE, a SwiGLU MLP and an optional tied head.  An optional KV
cache serves autoregressive decoding.

Unlike the JAX package's functional cache update, the KV cache here is a
list of preallocated per-layer ``{"k", "v"}`` tensors of shape
[B, total, Hkv, D], written in place; the returned caches are the same
tensors.

Memory levers of the trained student (the JAX fields of the same names):
``Qwen2LM(remat, remat_policy)`` recomputes each decoder layer in the
backward (``models/remat.py``: ``full``, ``dots`` or ``flash``);
``mlp_chunk`` runs the MLP in sequence chunks, each under its own
checkpoint, so the backward holds one chunk's [chunk, intermediate]
gate/up pair (``Qwen2MLP.seq_chunk``).  ``remat_barrier`` is kept for
parity and changes nothing: it is the JAX ``prevent_cse``, which stops XLA
from merging a recompute with its forward twin; eager PyTorch merges
nothing, so a checkpoint here always recomputes.

The attention reads its head counts from the projections' local widths,
not from the config, so a block whose projections are split over a
tensor-parallel group (``parallel/sharding.py``) runs its local heads.

``quant="int8"`` builds the block projections as :class:`QLinear` (w8a8,
the JAX ``QDense``) and ``embed_quant="int8"`` the token embedding as
:class:`QEmbedding` (the JAX ``QEmbed``) and the untied head as a
``QLinear`` holding the vocab-major int8 head, for the frozen teacher and
int8 serving.  A bf16 model is quantized in place by
``ops/int8.py::quantize_model_int8``; a model built with these modes takes
a quantized state dict (``models/convert.py::params_from_flax``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Qwen2Config
from ..ops.attention import FLASH_IMPLS, dot_product_attention, gqa_decode_attention
from ..ops._build import is_dtensor
from ..ops.int8 import absmax_quantize_weight, int8_matmul, int8_matmul_rowwise, quantize_embedding_int8
from .remat import check_policy, needs_remat, remat_call


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return self.weight * xf.to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] -> (cos, sin) each [B, S, head_dim]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
                  / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D] (NeoX half-rotation convention)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def write_cache(cache: torch.Tensor, x: torch.Tensor, index: Union[int, torch.Tensor]) -> None:
    """Write x [B, s, H, D] into cache [B, total, H, D] at ``index`` in place.

    ``index`` is an int (uniform prefill) or a [B] tensor (per-sample decode
    offsets under right padding).  Like ``lax.dynamic_update_slice``, an
    index is clamped so that the slice fits.
    """
    s = x.shape[1]
    hi = cache.shape[1] - s
    x = x.to(cache.dtype)
    if not torch.is_tensor(index) or index.ndim == 0:
        i = min(max(int(index), 0), hi)
        cache[:, i:i + s] = x
        return
    pos = index.clamp(0, hi)[:, None] + torch.arange(s, device=cache.device)[None, :]
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, pos] = x


# FSDP2 of torch 2.11 makes each sharded parameter with ``requires_grad`` set
# before it restores the flag, which an int8 tensor refuses.  So, for FSDP2,
# the int8 modules below hold ``weight_q`` as this one-byte float, its bytes
# unchanged (a dtype view, never a cast), and view it back where they read it;
# no other module knows the format.
INT8_CARRIER = torch.float8_e4m3fn


def _as_int8(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int8 else t.view(torch.int8)


class _Int8Weight(nn.Module):
    """``weight_q``'s format, shared by :class:`QLinear` and
    :class:`QEmbedding`: int8, or ``INT8_CARRIER`` once
    :meth:`hold_for_fsdp` has run."""

    def int8_weight(self) -> torch.Tensor:
        """``weight_q`` as int8, whole: a sharded ``weight_q`` (a DTensor,
        before FSDP2 has gathered it for a forward) is refused."""
        if is_dtensor(self.weight_q):
            raise ValueError("weight_q is still sharded: read it after the model's forward")
        return _as_int8(self.weight_q)

    def hold_for_fsdp(self) -> None:
        """Re-register ``weight_q`` as a frozen ``INT8_CARRIER`` view of the
        same bytes (a DTensor shard by shard), which FSDP2 can shard."""
        from torch.distributed.tensor import DTensor

        p = self.weight_q
        if p.dtype != torch.int8:
            return
        if isinstance(p, DTensor):
            data = DTensor.from_local(p.to_local().view(INT8_CARRIER), p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape, stride=p.stride())
        else:
            data = p.detach().view(INT8_CARRIER)
        self.weight_q = nn.Parameter(data, requires_grad=False)


class QLinear(_Int8Weight):
    """Int8 (w8a8) drop-in for ``nn.Linear`` on frozen paths (the JAX
    ``QDense``): ``weight_q`` int8 [out, in] (the torch layout, the
    transpose of the JAX ``kernel_q``), ``weight_scale`` f32 [out], an
    optional bias.  The output comes from ``ops/int8.py::int8_matmul`` in
    its XLA form (the JAX default) in the input's dtype; the bias is added
    after that cast, in that dtype, as ``QDense`` adds it.

    Split over a tensor-parallel group (``parallel/sharding.py``'s int8
    styles make ``weight_q`` a DTensor over the group): column-wise
    (``weight_q`` Shard(0)) the whole input gives this rank's output
    columns through ``int8_matmul`` with its local weight, scales and bias;
    row-wise (Shard(1)) the input is this rank's K shard, and the output,
    whole on every rank, comes from the split form
    ``int8_matmul_rowwise`` over the group, the bias added once, after
    the reduce."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight_q = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8, device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(out_features, dtype=torch.float32, device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype), requires_grad=False)
                     if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "QLinear":
        """The absmax int8 quantization of ``lin`` (per output channel)."""
        q = cls(lin.in_features, lin.out_features, bias=lin.bias is not None, device=lin.weight.device,
                dtype=lin.weight.dtype)
        q.weight_q.data, q.weight_scale.data = absmax_quantize_weight(lin.weight)
        if lin.bias is not None:
            q.bias.data = lin.bias.detach()
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, ws, bias = self.weight_q, self.weight_scale, self.bias
        if is_dtensor(wq):
            group = wq.device_mesh.get_group()
            rowwise = wq.placements[0].is_shard(1)
            wq, ws = _as_int8(wq.to_local()), ws.to_local()
            bias = None if bias is None else bias.to_local()
            if rowwise:
                y = int8_matmul_rowwise(x, wq, ws, group, out_dtype=x.dtype)
                return y if bias is None else y + bias.to(y.dtype)
        y = int8_matmul(x, _as_int8(wq), ws, out_dtype=x.dtype)
        return y if bias is None else y + bias.to(y.dtype)


class QEmbedding(_Int8Weight):
    """Int8 drop-in for ``nn.Embedding`` (the JAX ``QEmbed``):
    ``weight_q`` int8 [V, D] with a per-row f32 ``weight_scale`` [V, 1]; a
    lookup gathers the int8 row times its scale, then casts to ``dtype``.
    Untied models only: a tied head must stay float."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None, dtype=None):
        super().__init__()
        self.dtype = dtype or torch.get_default_dtype()
        self.weight_q = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim, dtype=torch.int8, device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(num_embeddings, 1, dtype=torch.float32, device=device), requires_grad=False)

    @classmethod
    @torch.no_grad()
    def from_embedding(cls, emb: nn.Embedding) -> "QEmbedding":
        q = cls(emb.num_embeddings, emb.embedding_dim, device=emb.weight.device, dtype=emb.weight.dtype)
        q.weight_q.data, q.weight_scale.data = quantize_embedding_int8(emb.weight)
        return q

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        rows = self.int8_weight()[input_ids].float()
        return (rows * self.weight_scale[input_ids, 0][..., None]).to(self.dtype)


def linear_cls(quant: str):
    """``nn.Linear`` for ``quant="none"``, :class:`QLinear` for ``"int8"``."""
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
    return QLinear if quant == "int8" else nn.Linear


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, attn_impl: str = "xla", quant: str = "none", device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        fk = dict(device=device, dtype=dtype)
        hd, b = cfg.head_dim, cfg.attention_bias
        lin = linear_cls(quant)
        self.q_proj = lin(cfg.hidden_size, cfg.num_attention_heads * hd, bias=b, **fk)
        self.k_proj = lin(cfg.hidden_size, cfg.num_key_value_heads * hd, bias=b, **fk)
        self.v_proj = lin(cfg.hidden_size, cfg.num_key_value_heads * hd, bias=b, **fk)
        self.o_proj = lin(cfg.num_attention_heads * hd, cfg.hidden_size, bias=False, **fk)

    def forward(self, x, cos, sin, mask, cache=None, cache_index=None):
        b, s, _ = x.shape
        hd = self.cfg.head_dim
        # local head counts: a tensor-parallel rank holds some of the heads
        q = apply_rope(self.q_proj(x).view(b, s, -1, hd), cos, sin)
        k = apply_rope(self.k_proj(x).view(b, s, -1, hd), cos, sin)
        v = self.v_proj(x).view(b, s, -1, hd)

        new_cache = None
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            index = 0 if cache_index is None else cache_index
            write_cache(ck, k, index)
            write_cache(cv, v, index)
            k, v = ck, cv
            new_cache = cache
            if s >= 128 and self.attn_impl in FLASH_IMPLS and mask is not None:
                # One-shot prefill into a fresh cache (the Generator always
                # prefills at cache index 0): the decode-mask rows are
                # causal AND kv-padding, so flash re-derives causality
                # (top-left aligned) and takes the kv padding from the most
                # permissive row, the last.
                out = dot_product_attention(
                    q, k, v, mask=mask[:, :, -1:, :], causal=True, impl=self.attn_impl
                )
            else:
                if s > 1:
                    # Cached multi-token call on the plain arm: encode
                    # causality against the cache here (a caller's
                    # decode mask already holds it; the AND is then a no-op).
                    ci = torch.as_tensor(index, device=x.device)
                    ci2 = ci[:, None] if ci.ndim == 1 else ci.reshape(1, 1)
                    q_pos = ci2 + torch.arange(s, device=x.device)[None, :]
                    k_pos = torch.arange(ck.shape[1], device=x.device)[None, None, :]
                    causal = (k_pos <= q_pos[:, :, None])[:, None]
                    mask = causal if mask is None else mask & causal
                # Decode steps (Sq = 1): grouped einsum, K/V never repeated.
                out = gqa_decode_attention(q, k, v, mask=mask)
        else:
            impl = self.attn_impl if s >= 128 else "xla"
            out = dot_product_attention(q, k, v, mask=mask, causal=True, impl=impl)

        out = self.o_proj(out.reshape(b, s, -1))
        return out, new_cache


class Qwen2MLP(nn.Module):
    """SwiGLU MLP.  ``seq_chunk`` > 0 (the JAX ``Qwen2MLP.seq_chunk``): when
    S > seq_chunk and S % seq_chunk == 0, the MLP runs chunk by chunk along
    the sequence, each chunk under its own checkpoint when autograd needs
    it, so the backward holds one chunk's [chunk, intermediate] gate/up
    pair instead of the whole sequence's."""

    def __init__(self, cfg: Qwen2Config, quant: str = "none", seq_chunk: int = 0, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(bias=False, device=device, dtype=dtype)
        lin = linear_cls(quant)
        self.seq_chunk = seq_chunk
        self.gate_proj = lin(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.up_proj = lin(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.down_proj = lin(cfg.intermediate_size, cfg.hidden_size, **fk)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ck = self.seq_chunk
        s = x.shape[1] if x.ndim == 3 else 0
        if not (ck and s > ck and s % ck == 0):
            return self._ff(x)
        remat = needs_remat(x, *self.parameters())
        parts = [x[:, i:i + ck] for i in range(0, s, ck)]
        return torch.cat([remat_call(self._ff, "full", p) if remat else self._ff(p) for p in parts], dim=1)


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config, attn_impl: str = "xla", quant: str = "none", mlp_chunk: int = 0,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.self_attn = Qwen2Attention(cfg, attn_impl, quant, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.mlp = Qwen2MLP(cfg, quant, mlp_chunk, **fk)

    def forward(self, x, cos, sin, mask, cache=None, cache_index=None):
        h, new_cache = self.self_attn(self.input_layernorm(x), cos, sin, mask, cache, cache_index)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class Qwen2LM(nn.Module):
    """Decoder LM.  Call with input_ids OR precomputed inputs_embeds.

    Returns (logits, new_caches); new_caches is None unless caches were given.
    ``quant="int8"``: w8a8 block projections; ``embed_quant="int8"``: the
    int8 token embedding and int8 vocab-major head (untied models only).
    ``remat``, ``remat_policy``, ``mlp_chunk``, ``remat_barrier``: the
    memory levers of the module docstring, with the JAX defaults.
    """

    def __init__(self, cfg: Qwen2Config, attn_impl: str = "xla", quant: str = "none",
                 embed_quant: str = "none", device=None, dtype=None, remat: bool = False,
                 remat_policy: str = "full", mlp_chunk: int = 0, remat_barrier: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat, self.remat_policy = remat, check_policy(remat_policy)
        self.mlp_chunk, self.remat_barrier = mlp_chunk, remat_barrier
        fk = dict(device=device, dtype=dtype)
        if embed_quant == "int8" and cfg.tie_word_embeddings:
            raise ValueError("embed_quant='int8' is for untied (frozen-teacher) models: "
                             "a tied head must stay float")
        head = linear_cls(embed_quant)
        self.embed_tokens = (QEmbedding if embed_quant == "int8" else nn.Embedding)(
            cfg.vocab_size, cfg.hidden_size, **fk)
        self.layers = nn.ModuleList(
            Qwen2Layer(cfg, attn_impl, quant, mlp_chunk, **fk) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        if not cfg.tie_word_embeddings:
            self.lm_head = head(cfg.hidden_size, cfg.vocab_size, bias=False, **fk)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        caches: Optional[List[dict]] = None,
        cache_index=None,
        return_hidden: bool = False,
        compute_logits: bool = True,
        decode_mask: Optional[torch.Tensor] = None,
    ):
        c = self.cfg
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds
        b, s, _ = x.shape

        if positions is None:
            # Cached calls offset positions by the write index.
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            if caches is not None and cache_index is not None:
                ci = torch.as_tensor(cache_index, device=x.device)
                positions = positions + (ci[:, None] if ci.ndim == 1 else ci)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta, x.dtype)

        # attention_mask [B, Skv] -> [B, 1, 1, Skv]; decode_mask is an
        # explicit [B, 1, Sq, Skv] and overrides it.
        mask = None
        if decode_mask is not None:
            mask = decode_mask.to(torch.bool)
        elif attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)

        new_caches = [] if caches is not None else None
        remat = self.remat and caches is None and needs_remat(x, *self.parameters())
        for i, layer in enumerate(self.layers):
            if remat:
                x, nc = remat_call(layer, self.remat_policy, x, cos, sin, mask)
            else:
                x, nc = layer(x, cos, sin, mask, None if caches is None else caches[i], cache_index)
            if caches is not None:
                new_caches.append(nc)

        x = self.norm(x)
        if not compute_logits:
            logits = None
        elif c.tie_word_embeddings:
            logits = F.linear(x, self.embed_tokens.weight)
        else:
            logits = self.lm_head(x)
        if return_hidden:
            return logits, new_caches, x
        return logits, new_caches
