"""LLaVA-OneVision: SigLIP tower + projector + Qwen2 LM with static-shape
anyres feature packing (port of the JAX package's ``models/llava_onevision.py``).

Inputs keep the JAX layout:
  input_ids        [B, S]
  attention_mask   [B, S]
  pixel_values     [B, P, H, W, 3]   (P = padded tile budget, NHWC)
  pack_idx         [B, M, 4] int     (M = max packed image tokens)
  pack_weight      [B, M, 4] float
  pack_valid       [B, M] bool
  tile_valid       [B, P] bool
The host computes the anyres unpad/downsample/newline packing as a gather
spec (``data/anyres.build_pack_spec`` in the JAX package); on the device it
is four single-tap gathers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import LlavaOnevisionConfig
from ..utils.trace import span
from .qwen2 import QEmbedding, QLinear, Qwen2LM, RMSNorm
from .siglip import SigLIPVisionTower


class MultiModalProjector(nn.Module):
    def __init__(self, cfg: LlavaOnevisionConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(bias=cfg.projector_bias, device=device, dtype=dtype)
        d = cfg.text.hidden_size
        self.linear_1 = nn.Linear(cfg.vision.hidden_size, d, **fk)
        self.linear_2 = nn.Linear(d, d, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x)))  # exact gelu, as HF "gelu"


class _PackTaps(torch.autograd.Function):
    """packed[b, m] = sum_k w[b, m, k] * bank[b, idx[b, m, k]], the bilinear
    taps of the anyres pack, forward as sequential single-tap gathers.

    The autograd backward of ``torch.gather`` on CUDA scatter-adds with
    atomics, and the taps hit the same bank rows many times, so the bank's
    gradient (the projector's and the vision tower's) changed its low bits
    from run to run.  Here the backward is one batched product with the tap
    matrix W [B, M, n] (W[b, m, j] = the summed weights of the taps of m at
    j, built tap by tap, each scatter writing distinct places):
    d bank = W^T d packed."""

    @staticmethod
    def forward(ctx, bank, idx, w):
        d = bank.shape[-1]
        packed = None
        for k in range(idx.shape[-1]):
            tap = torch.gather(bank, 1, idx[:, :, k, None].expand(-1, -1, d))  # [B, M, D]
            term = tap * w[:, :, k, None]
            packed = term if packed is None else packed + term
        ctx.save_for_backward(idx, w)
        ctx.bank_rows = bank.shape[1]
        return packed

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        b, m, taps = idx.shape
        tap_matrix = torch.zeros(b, m, ctx.bank_rows, dtype=torch.float32, device=g.device)
        for k in range(taps):
            tap_matrix.scatter_add_(2, idx[:, :, k, None], w[:, :, k, None].float())
        return torch.bmm(tap_matrix.transpose(1, 2).to(g.dtype), g), None, None


class LlavaOnevision(nn.Module):
    """``lm_quant`` / ``vision_quant`` ("none" or "int8"): w8a8 projections
    in the LM's decoder blocks / the SigLIP encoder; ``embed_quant``: the
    int8 token embedding and vocab-major head (untied LMs); the projector
    stays float (the JAX ``LlavaOnevision`` fields of the same names).

    ``remat`` recomputes the layers of both towers in the backward
    (``remat_vision=False`` keeps the tower's activations), with
    ``remat_policy`` for both (``models/remat.py``); ``mlp_chunk`` is the
    LM's sequence-chunked MLP and ``remat_barrier`` a no-op kept for parity
    (``models/qwen2.py``).  Passed down as in the JAX ``setup``.  A frozen
    model runs under ``no_grad``, where its remat recomputes nothing."""

    def __init__(self, cfg: LlavaOnevisionConfig, attn_impl: str = "xla", device=None, dtype=None,
                 lm_quant: str = "none", vision_quant: str = "none", embed_quant: str = "none",
                 remat: bool = False, remat_vision: bool = True, remat_policy: str = "full",
                 mlp_chunk: int = 0, remat_barrier: bool = False):
        super().__init__()
        self.cfg = cfg
        fk = dict(device=device, dtype=dtype)
        self.vision_tower = SigLIPVisionTower(cfg.vision, attn_impl, vision_quant, **fk,
                                              remat=remat and remat_vision, remat_policy=remat_policy,
                                              remat_barrier=remat_barrier)
        self.multi_modal_projector = MultiModalProjector(cfg, **fk)
        self.image_newline = nn.Parameter(torch.empty(cfg.text.hidden_size, **fk))
        self.language_model = Qwen2LM(cfg.text, attn_impl, lm_quant, embed_quant, **fk, remat=remat,
                                      remat_policy=remat_policy, mlp_chunk=mlp_chunk,
                                      remat_barrier=remat_barrier)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_newline.dtype

    @property
    def device(self) -> torch.device:
        return self.image_newline.device

    def encode_images(self, pixel_values: torch.Tensor):
        """[B, P, H, W, 3] -> (projected [B, P, T, Dt], post_ln [B, P, T, Dv])."""
        b, p = pixel_values.shape[:2]
        with span("vision"):
            encoder_out, post_ln = self.vision_tower(pixel_values.flatten(0, 1))
            projected = self.multi_modal_projector(encoder_out)
        t = projected.shape[1]
        return projected.reshape(b, p, t, -1), post_ln.reshape(b, p, t, -1)

    def pack_features(self, projected, pack_idx, pack_weight, pack_valid):
        """Gather-pack projected tile features into [B, M, Dt].

        bank[b] = concat(projected[b].reshape(P*T, D), image_newline); the
        four bilinear taps run as sequential single-tap gathers
        (:class:`_PackTaps`, whose backward is deterministic).
        """
        b, p, t, d = projected.shape
        bank = torch.cat(
            [projected.reshape(b, p * t, d),
             self.image_newline.to(projected.dtype)[None, None, :].expand(b, 1, d)],
            dim=1,
        )
        packed = _PackTaps.apply(bank, pack_idx.long(), pack_weight.to(projected.dtype))
        return packed * pack_valid[..., None].to(projected.dtype)

    def merge_image_features(self, input_ids, inputs_embeds, packed):
        """Place packed[b, j] at the j-th image-token position of sample b."""
        img_mask = input_ids == self.cfg.image_token_id
        feat_pos = (img_mask.long().cumsum(dim=1) - 1).clamp(0, packed.shape[1] - 1)
        d = packed.shape[-1]
        img_embeds = torch.gather(packed, 1, feat_pos[..., None].expand(-1, -1, d))
        return torch.where(img_mask[..., None], img_embeds.to(inputs_embeds.dtype), inputs_embeds)

    def forward(
        self,
        input_ids: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        pack_idx: Optional[torch.Tensor] = None,
        pack_weight: Optional[torch.Tensor] = None,
        pack_valid: Optional[torch.Tensor] = None,
        tile_valid: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        caches: Optional[list] = None,
        cache_index=None,
        return_hidden: bool = False,
        compute_logits: bool = True,
        decode_mask: Optional[torch.Tensor] = None,
    ):
        """Returns (logits [B,S,V], vision_features [B,P,Dv], new_caches), or
        with ``return_hidden=True`` a 4-tuple that adds the final-norm hidden
        states.  vision_features are per-tile mean-pooled post_layernorm
        outputs, zeroed at padded tiles."""
        inputs_embeds = self.language_model.embed(input_ids)
        vision_features = None
        if pixel_values is not None:
            projected, post_ln = self.encode_images(pixel_values)
            packed = self.pack_features(projected, pack_idx, pack_weight, pack_valid)
            inputs_embeds = self.merge_image_features(input_ids, inputs_embeds, packed)
            pooled = post_ln.mean(dim=2)  # [B, P, Dv]
            if tile_valid is not None:
                pooled = pooled * tile_valid[..., None].to(pooled.dtype)
            vision_features = pooled

        out = self.language_model(
            inputs_embeds=inputs_embeds,
            attention_mask=attention_mask,
            positions=positions,
            caches=caches,
            cache_index=cache_index,
            return_hidden=return_hidden,
            compute_logits=compute_logits,
            decode_mask=decode_mask,
        )
        if return_hidden:
            logits, new_caches, hidden = out
            return logits, vision_features, new_caches, hidden
        logits, new_caches = out
        return logits, vision_features, new_caches


def set_attn_impl(model: nn.Module, impl: str) -> None:
    """Switch every attention module of ``model`` to ``impl`` (``ops/attention.py::IMPLS``)."""
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


@torch.no_grad()
def init_weights(model: LlavaOnevision, seed: int) -> LlavaOnevision:
    """Seeded random init with the Flax modules' distributions: lecun-normal
    dense and conv kernels (truncated at 2 sigma), zero biases, unit norms,
    N(0, 0.02) token and position embeddings, N(0, 1/sqrt(D)) image newline.
    Draws on a ``torch.Generator`` on the model's device, one tensor at a
    time in float32, and casts each into its parameter: a bf16 model gets
    the same numbers, rounded, without a float32 copy of the whole model.
    A model built with int8 modules is refused: draw the float weights, then
    quantize (``ops/int8.py::quantize_model_int8``)."""
    if any(isinstance(m, (QLinear, QEmbedding)) for m in model.modules()):
        raise ValueError("init_weights draws float weights: build the model without quant modes "
                         "and quantize it after")
    g = torch.Generator(device=model.device).manual_seed(seed)

    def fill(param, draw, **kw):
        x = torch.empty(param.shape, dtype=torch.float32, device=param.device)
        draw(x, generator=g, **kw)
        param.copy_(x)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = math.prod(m.weight.shape[1:])
            std = fan_in**-0.5 / 0.87962566103423978  # truncated-normal correction
            fill(m.weight, nn.init.trunc_normal_, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            fill(m.weight, nn.init.normal_, std=0.02)
    fill(model.vision_tower.position_embedding, nn.init.normal_, std=0.02)
    fill(model.image_newline, nn.init.normal_, std=model.cfg.text.hidden_size**-0.5)
    return model
