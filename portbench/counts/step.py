"""Operations a training step needs, and the kernel launches it makes,
from the configuration, the job and each sample's frame.

Counted is the work the inputs need, with nothing recomputed:

* vision: the valid tiles only (a padded tile changes no loss);
* language model: the rows the loss reads.  CE (the baseline) reads the real
  tokens; LoCa and the temperature KL are means over every row of the
  bucket, padding included (as the reference writes them), so the KD jobs
  read all ``seq_bucket`` rows of both models;
* a backward: weight gradients for the parameters the job trains, and
  activation gradients only where a trained parameter lies below (the
  patch embedding's input, the pixels, needs none); the attention backward
  is its four products (2x the forward's two), the scores not recomputed;
* the teacher's head over the rows its logits are read at, truncated to the
  student's vocabulary.

``Sample`` describes one sample: its valid tiles and real tokens.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

from . import kernels


class Sample(NamedTuple):
    tiles: int  # valid anyres tiles, the base tile included
    tokens: int  # real (non-pad) tokens


def _vision(vc: dict) -> Tuple[float, float, float, int]:
    """(patch, linear, attention) forward operations of one tile, and its tokens."""
    t = (vc["image_size"] // vc["patch_size"]) ** 2
    d, i, layers = vc["hidden_size"], vc["intermediate_size"], vc["num_hidden_layers"]
    patch = 2.0 * t * 3 * vc["patch_size"] ** 2 * d
    linear = layers * (2.0 * t * d * 4 * d + 2 * 2.0 * t * d * i)
    attention = layers * 4.0 * t * t * d
    return patch, linear, attention, t


def _projector(vc: dict, tc: dict) -> float:
    t = (vc["image_size"] // vc["patch_size"]) ** 2
    return 2.0 * t * (vc["hidden_size"] * tc["hidden_size"] + tc["hidden_size"] ** 2)


def head_dim(tc: dict) -> int:
    return tc.get("head_dim") or tc["hidden_size"] // tc["num_attention_heads"]


def _lm(tc: dict, rows: int, valid: int) -> Tuple[float, float]:
    """(linear, attention) forward operations of ``rows`` rows over a
    causal mask with ``valid`` valid keys."""
    d, i, hd = tc["hidden_size"], tc["intermediate_size"], head_dim(tc)
    hq, hkv, layers = tc["num_attention_heads"], tc["num_key_value_heads"], tc["num_hidden_layers"]
    per_token = 2.0 * d * (hq * hd + 2 * hkv * hd) + 2.0 * hq * hd * d + 3 * 2.0 * d * i
    pairs = kernels.attended_pairs(rows, [valid], causal=True)
    return layers * rows * per_token, layers * 4.0 * pairs * hq * hd


def lm_rows(job: dict, seq_bucket: int, tokens: int) -> Tuple[int, int]:
    """(rows the language models run over, rows the head is read at)."""
    if job["objective"] == "baseline":
        return tokens, tokens - 1  # CE: each real token but the last predicts one
    return seq_bucket, seq_bucket  # LoCa / KL: every row of the bucket


def sample_flops(config: dict, job: dict, seq_bucket: int, s: Sample) -> Dict[str, float]:
    """Operations one sample needs, by part."""
    st, te = config["student"], config.get("teacher")
    vc, tc = st["vision_config"], st["text_config"]
    rows, head_rows = lm_rows(job, seq_bucket, s.tokens)
    lm_frozen = job["objective"] == "double_trouble" and job["phase"] == 1
    patch, lin, attn, _ = _vision(vc)
    out = {"student_vision": s.tiles * (2 * patch + 3 * lin + 3 * attn),
           "student_projector": s.tiles * 3 * _projector(vc, tc)}
    lm_lin, lm_attn = _lm(tc, rows, s.tokens)
    head = 2.0 * head_rows * tc["hidden_size"] * tc["vocab_size"]
    if lm_frozen:  # activation gradients only, down to the image features
        out["student_lm"] = 2 * lm_lin + 3 * lm_attn
        out["student_head"] = 2 * head
    else:
        out["student_lm"] = 3 * (lm_lin + lm_attn)
        out["student_head"] = 3 * head
    if job["objective"] != "baseline":
        tvc, ttc = te["vision_config"], te["text_config"]
        patch, lin, attn, _ = _vision(tvc)
        t_lin, t_attn = _lm(ttc, rows, s.tokens)
        out["teacher_vision"] = s.tiles * (patch + lin + attn)
        out["teacher_projector"] = s.tiles * _projector(tvc, ttc)
        out["teacher_lm"] = t_lin + t_attn
        out["teacher_head"] = 2.0 * head_rows * ttc["hidden_size"] * tc["vocab_size"]
    return out


def step_flops(config: dict, job: dict, seq_bucket: int, samples: Sequence[Sample]) -> float:
    """Operations one optimizer step over ``samples`` needs."""
    return sum(sum(sample_flops(config, job, seq_bucket, s).values()) for s in samples)


def micro_batch_launches(config: dict, job: dict, seq_bucket: int,
                         samples: Sequence[Sample]) -> Dict[str, List[Tuple[str, float, float, int]]]:
    """The port's kernel launches in one micro-batch, by family ("flash",
    "ce", "kl", "loca_ce"): (kernel, operations, bytes, launches), each at
    the work this micro-batch's inputs need."""
    st, te = config["student"], config.get("teacher")
    vc, tc = st["vision_config"], st["text_config"]
    kd = job["objective"] != "baseline"
    tiles = sum(s.tiles for s in samples)
    t = (vc["image_size"] // vc["patch_size"]) ** 2
    hv, dv = vc["num_attention_heads"], vc["hidden_size"] // vc["num_attention_heads"]
    lv = vc["num_hidden_layers"]
    per = [lm_rows(job, seq_bucket, s.tokens) for s in samples]
    keys = [s.tokens for s in samples]
    rows = [r for r, _ in per]
    k1 = kernels.flash_fwd([(t, t, t)] * tiles, hv, hv, dv, causal=False, masked=False, lse=True)
    k2 = kernels.flash_bwd([(t, t, t)] * tiles, hv, hv, dv, causal=False, masked=False)
    lm = [(r, r, k) for r, k in zip(rows, keys)]
    hq, hkv, hd, ll = tc["num_attention_heads"], tc["num_key_value_heads"], head_dim(tc), tc["num_hidden_layers"]
    k3 = kernels.flash_fwd(lm, hq, hkv, hd, causal=True, masked=True, lse=True)
    k4 = kernels.flash_bwd(lm, hq, hkv, hd, causal=True, masked=True)
    flash = [("K1", *k1, lv), ("K2", *k2, lv), ("K3 d64", *k3, ll), ("K4", *k4, ll)]
    if kd:
        ttc = te["text_config"]
        k1t = kernels.flash_fwd([(t, t, t)] * tiles, hv, hv, dv, causal=False, masked=False, lse=False)
        k3t = kernels.flash_fwd(lm, ttc["num_attention_heads"], ttc["num_key_value_heads"], head_dim(ttc),
                                causal=True, masked=True, lse=False)
        flash += [("K1 teacher", *k1t, te["vision_config"]["num_hidden_layers"]),
                  ("K3 d128", *k3t, ttc["num_hidden_layers"])]
    n = sum(h for _, h in per)
    d, v = tc["hidden_size"], tc["vocab_size"]
    out = {"flash": flash}
    if not kd:
        out["ce"] = [("K5", *kernels.ce_fwd(n, d, v), 1), ("K6", *kernels.ce_bwd(n, d, v), 1)]
    elif job["phase"] == 1:
        out["kl"] = [("K7", *kernels.kl_fwd(n, d, v), 1), ("K8 dh", *kernels.kl_bwd(n, d, v, need_dw=False), 1)]
    else:
        out["loca_ce"] = [("K11 fwd", *kernels.loca_ce_fwd(n, d, v), 1),
                          ("K11 bwd", *kernels.loca_ce_bwd(n, d, v), 1)]
    return out
