"""SigLIP vision tower (port of the JAX package's ``models/siglip.py``).

Conv patch embed + learned position embeddings (no CLS), pre-LN encoder
layers with biased QKV and a gelu-tanh MLP, and a final ``post_layernorm``.
The tower returns ``(last_hidden, post_ln)``, both [N, T, D]: the projector
reads the first, feature KD the second.  ``quant="int8"`` builds the
attention and MLP projections as w8a8 ``QLinear`` (the JAX
``vision_quant``); the patch conv, norms and position embedding stay float.
``remat``, ``remat_policy`` and ``remat_barrier`` recompute each encoder
layer in the backward, as ``models/qwen2.py`` describes.  The attention
takes its head count from the projections' local width (tensor
parallelism).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import SigLIPVisionConfig
from ..ops.attention import dot_product_attention
from .qwen2 import linear_cls
from .remat import check_policy, needs_remat, remat_call


class SigLIPAttention(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig, attn_impl: str = "xla", quant: str = "none", device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        fk = dict(bias=True, device=device, dtype=dtype)
        d = cfg.hidden_size
        lin = linear_cls(quant)
        self.q_proj = lin(d, d, **fk)
        self.k_proj = lin(d, d, **fk)
        self.v_proj = lin(d, d, **fk)
        self.out_proj = lin(d, d, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, -1, self.cfg.head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = dot_product_attention(q, k, v, impl=self.attn_impl)
        return self.out_proj(out.reshape(b, s, -1))


class SigLIPMLP(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig, quant: str = "none", device=None, dtype=None):
        super().__init__()
        fk = dict(bias=True, device=device, dtype=dtype)
        lin = linear_cls(quant)
        self.fc1 = lin(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.fc2 = lin(cfg.intermediate_size, cfg.hidden_size, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))  # gelu_pytorch_tanh


class SigLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig, attn_impl: str = "xla", quant: str = "none", device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **fk)
        self.self_attn = SigLIPAttention(cfg, attn_impl, quant, **fk)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **fk)
        self.mlp = SigLIPMLP(cfg, quant, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class SigLIPVisionTower(nn.Module):
    """Returns (last_layer_hidden, post_layernorm_hidden), both [N, T, D]."""

    def __init__(self, cfg: SigLIPVisionConfig, attn_impl: str = "xla", quant: str = "none", device=None,
                 dtype=None, remat: bool = False, remat_policy: str = "full", remat_barrier: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat, self.remat_policy, self.remat_barrier = remat, check_policy(remat_policy), remat_barrier
        fk = dict(device=device, dtype=dtype)
        self.patch_embedding = nn.Conv2d(
            3, cfg.hidden_size, kernel_size=cfg.patch_size, stride=cfg.patch_size, **fk
        )
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.tokens_per_patch, cfg.hidden_size, **fk)
        )
        self.layers = nn.ModuleList(
            SigLIPEncoderLayer(cfg, attn_impl, quant, **fk) for _ in range(cfg.num_hidden_layers)
        )
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **fk)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values: [N, H, W, 3] (NHWC, the JAX layout), already normalized."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixel_values.to(w.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # [N, T, D], row-major patch order
        x = x + self.position_embedding[None]
        remat = self.remat and needs_remat(x, *self.parameters())
        for layer in self.layers:
            x = remat_call(layer, self.remat_policy, x) if remat else layer(x)
        return x, self.post_layernorm(x)
