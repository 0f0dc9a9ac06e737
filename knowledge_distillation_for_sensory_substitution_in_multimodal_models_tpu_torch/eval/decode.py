"""Greedy autoregressive decoding with the reference's effective generation
config (port of the JAX package's ``eval/decode.py``).

``generate(max_new_tokens=32, repetition_penalty=1.2,
no_repeat_ngram_size=2, temperature=0.7)`` without ``do_sample``: decoding
is greedy and temperature is ignored.  One prefill (the full prompt through
the model, KV caches filled, an Sq x Skv causal+padding mask), then a Python
loop of single-token steps; the JAX package's jit and ``lax.scan`` become
eager code.  All state stays on the model's device: no step reads a value
back to the host.

Under a mesh (``parallel/sharding.py::shard_params``) the model's
parameters are DTensors and every rank runs the whole batch: each layer's
KV cache holds that rank's kv heads (``local_kv_heads``: kv / t where the
tensor plan splits the attention), and the loop runs exactly
``max_new_tokens`` steps with no early exit, so that every rank makes the
same forward calls (FSDP2 all-gathers in each).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..configs import LlavaOnevisionConfig


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Same fields and checks as the JAX package's ``GenerateConfig``
    (redeclared: that module imports jax)."""

    max_new_tokens: int = 32
    repetition_penalty: float = 1.2
    # any n >= 2 (HF semantics; the reference's value is 2), 0/None = off
    no_repeat_ngram_size: int = 2
    eos_token_id: int = 151645
    # accepted for flag parity; greedy decode ignores it
    temperature: float = 0.7
    allowed_token_ids: Optional[tuple] = None

    def __post_init__(self):
        if self.no_repeat_ngram_size not in (0, None) and self.no_repeat_ngram_size < 2:
            raise ValueError(
                f"no_repeat_ngram_size={self.no_repeat_ngram_size}: use 0/None (off) or n >= 2"
            )
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


def _apply_repetition_penalty(logits, presence, penalty):
    """HF RepetitionPenaltyLogitsProcessor: score/p if > 0 else score*p for
    every token already present in the sequence."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def _scatter_or(table: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """table[b, index[b, j]] |= src[b, j] for bool [B, V] ``table``.  An
    ``amax`` scatter, so duplicate indices never lose a True."""
    return table.int().scatter_reduce(1, index.long(), src.int(), reduce="amax") > 0


def _ngram_ban_mask(ids, valid, prefix, vocab):
    """Ban mask [B, V]: tokens t where (prefix..., t) occurs as an n-gram
    anywhere in ids (HF NoRepeatNGramLogitsProcessor over the full
    prompt+generated buffer).

    ids [B, L] full buffer, valid [B, L] marks real tokens, prefix [B, n-1]
    the last n-1 real tokens so far.  Window j bans ids[j+n-1] iff all n
    window slots are valid and the first n-1 equal the prefix.
    """
    b, l = ids.shape
    m = prefix.shape[1]  # n - 1
    match = valid[:, m:]
    for k in range(m):
        match = match & (ids[:, k:l - m + k] == prefix[:, k:k + 1]) & valid[:, k:l - m + k]
    ban = torch.zeros(b, vocab, dtype=torch.bool, device=ids.device)
    return _scatter_or(ban, ids[:, m:], match)


def local_kv_heads(model) -> List[int]:
    """Each LM layer's kv heads on this rank: its ``k_proj``'s local output
    width over the head dim (the config's count on a model that is not
    split over ``tensor``)."""
    from ..parallel.sharding import local_out_features

    hd = model.cfg.text.head_dim
    return [local_out_features(layer.self_attn.k_proj) // hd for layer in model.language_model.layers]


class Generator:
    """Greedy generator.

    ``gen = Generator(model_cfg, gen_cfg); out = gen.generate(model, batch)``
    where batch carries the ``student_*`` keys of the collator (eval mode) as
    tensors on the model's device.  Returns a dict with "sequences"
    [B, S+N], "valid" [B, S+N], "lengths" (prompt + generated real tokens),
    "prompt_lengths", "finished" [B], "tokens" [B, N] and "margins" [B, N]
    (the top-2 gap of the processed logits at each step).
    """

    def __init__(self, model_cfg: LlavaOnevisionConfig, gen_cfg: GenerateConfig = GenerateConfig()):
        self.cfg = model_cfg
        self.gcfg = gen_cfg

    def init_caches(self, b: int, total: int, dtype, device, kv_heads: Optional[Sequence[int]] = None):
        """Preallocated per-layer KV caches [B, total, Hkv, D], written in
        place; ``kv_heads``: each layer's Hkv (default: the config's)."""
        c = self.cfg.text
        if kv_heads is None:
            kv_heads = [c.num_key_value_heads] * c.num_hidden_layers
        return [
            {"k": torch.zeros((b, total, h, c.head_dim), dtype=dtype, device=device),
             "v": torch.zeros((b, total, h, c.head_dim), dtype=dtype, device=device)}
            for h in kv_heads
        ]

    def prefill(self, model, batch):
        """Run the prompt through ``model`` into fresh caches.

        Returns (logits [B, S, V], caches, prompt lengths [B])."""
        ids = batch["student_input_ids"].long()
        mask = batch["student_attention_mask"]
        b, s = ids.shape
        total = s + self.gcfg.max_new_tokens
        dev = ids.device
        lengths = mask.sum(dim=1)  # [B] prompt lengths (right padding)
        caches = self.init_caches(b, total, model.dtype, dev, local_kv_heads(model))
        # causal + padding mask over the cache buffer
        q_pos = torch.arange(s, device=dev)[None, :, None]
        k_pos = torch.arange(total, device=dev)[None, None, :]
        prefill_mask = (k_pos <= q_pos) & (k_pos < lengths[:, None, None])
        logits, _, caches = model(
            input_ids=ids,
            pixel_values=batch.get("student_pixel_values"),
            pack_idx=batch.get("pack_idx"),
            pack_weight=batch.get("pack_weight"),
            pack_valid=batch.get("pack_valid"),
            tile_valid=batch.get("tile_valid"),
            positions=torch.arange(s, device=dev)[None].expand(b, s),
            caches=caches,
            cache_index=0,
            decode_mask=prefill_mask[:, None],  # [B, 1, S, total]
        )
        return logits, caches, lengths

    @torch.no_grad()
    def generate(self, model, batch) -> Dict[str, torch.Tensor]:
        gc = self.gcfg
        vocab = self.cfg.text.vocab_size
        ids = batch["student_input_ids"].long()
        mask = batch["student_attention_mask"].bool()
        b, s = ids.shape
        n = gc.max_new_tokens
        total = s + n
        dev = ids.device
        rows = torch.arange(b, device=dev)

        logits, caches, lengths = self.prefill(model, batch)
        # last real prompt token's logits per sample
        last_idx = (lengths - 1).clamp(0, s - 1)
        next_logits = logits[rows, last_idx].float()  # [B, V]
        del logits

        # id buffer padded out to total for n-gram bookkeeping
        buf = torch.cat([ids, torch.zeros(b, n, dtype=ids.dtype, device=dev)], dim=1)
        valid = torch.cat([mask, torch.zeros(b, n, dtype=torch.bool, device=dev)], dim=1)
        presence = _scatter_or(torch.zeros(b, vocab, dtype=torch.bool, device=dev), ids, mask)
        # carried n-gram prefix: the last (n-1) real prompt tokens
        nprev = max((gc.no_repeat_ngram_size or 0) - 1, 1)
        pidx = (lengths[:, None] - nprev + torch.arange(nprev, device=dev)[None, :]).clamp(0, s - 1)
        last_tok = torch.gather(ids, 1, pidx)  # [B, n-1]
        finished = torch.zeros(b, dtype=torch.bool, device=dev)

        allowed = None
        if gc.allowed_token_ids is not None:
            allowed = torch.zeros(vocab, dtype=torch.bool, device=dev)
            allowed[torch.as_tensor(gc.allowed_token_ids, device=dev)] = True

        def pick_token(lg):
            lg = _apply_repetition_penalty(lg, presence, gc.repetition_penalty)
            if gc.no_repeat_ngram_size and gc.no_repeat_ngram_size >= 2:
                ban = _ngram_ban_mask(buf, valid, last_tok, vocab)
                lg = lg.masked_fill(ban, float("-inf"))
            if allowed is not None:
                lg = lg.masked_fill(~allowed[None, :], float("-inf"))
            top2 = lg.topk(2, dim=-1).values
            tok = lg.argmax(dim=-1)
            return torch.where(finished, torch.full_like(tok, gc.eos_token_id), tok), top2[:, 0] - top2[:, 1]

        cur_len = lengths.clone()
        k_pos = torch.arange(total, device=dev)[None, None, :]
        toks, margins = [], []
        for step in range(n):
            tok, margin = pick_token(next_logits)
            toks.append(tok)
            margins.append(margin)
            buf[rows, cur_len] = tok
            valid[rows, cur_len] |= ~finished
            presence[rows, tok] |= ~finished
            finished = finished | (tok == gc.eos_token_id)
            last_tok = torch.cat([last_tok[:, 1:], tok[:, None]], dim=1)
            if step == n - 1:
                # the N-th pick needs no trailing one-token forward
                break
            write_pos = cur_len
            step_mask = (k_pos <= write_pos[:, None, None])[:, None]  # [B, 1, 1, total]
            logits, _, caches = model(
                input_ids=tok[:, None],
                positions=write_pos[:, None],
                caches=caches,
                cache_index=write_pos,
                decode_mask=step_mask,
            )
            next_logits = logits[:, 0].float()
            cur_len = cur_len + 1

        return {
            "sequences": buf,
            "valid": valid,
            # prompt + generated real tokens (incl. the closing eos)
            "lengths": valid.sum(dim=1),
            "prompt_lengths": lengths,
            "finished": finished,
            "tokens": torch.stack(toks, dim=1),  # [B, N] in generation order
            # [B, N]: the best minus the second-best processed logit at each
            # step, how close greedy decoding came to another token
            "margins": torch.stack(margins, dim=1),
        }
