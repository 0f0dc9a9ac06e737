"""Plain float32 LLaVA-OneVision training step: the reference that decides
``correct``.

Written from the published architectures (HF transformers'
``SiglipVisionModel``, ``LlavaOnevisionModel.pack_image_features``; the
language model that the ``text_config``'s ``model_type`` names runs from
``lm/<model_type>.py``) and the project's losses (masked CE; LoCa,
paper-correct, and the temperature KL over every row, times T^2; NT-Xent
over the valid tiles' pooled post-layernorm features) and AdamW (decoupled weight decay,
bias-corrected moments).  Every product runs in float32 with TF32 off, on weights stored as
the configuration stores them (float32 masters, read rounded to its bf16);
``precision="fp8"`` rounds both operands of every linear product and of
the heads to float8 e4m3 (a per-tensor absmax scale, gradients passed
straight through): the control, a step computed below the configuration's
bf16.

Memory: each layer runs under ``torch.utils.checkpoint`` (recomputed in
the backward), attention runs one sample at a time, and the vocabulary
terms run over blocks of rows, each block recomputed in the backward; the
frozen teacher's bf16 weights are widened to float32 one use at a time.
Padded tiles are not run: no loss reads them.  The departures from the
published forward are none; from a deployment: random weights and inputs
(``portbench/weights.py``, ``portbench/traffic.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import anyres, lm
from .layers import Weights, attention, checkpointed, linear

IGNORE = -100
ROW_BLOCK = 512


def set_float32_exact() -> None:
    """Float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --- SigLIP -----------------------------------------------------------------

def siglip(W: Weights, vc: dict, pixels: torch.Tensor, precision: str, ckpt: bool):
    """pixels [N, H, W, 3] -> (last hidden state, post-layernorm), [N, T, D]."""
    p, d, heads = vc["patch_size"], vc["hidden_size"], vc["num_attention_heads"]
    eps = vc["layer_norm_eps"]
    n, side = pixels.shape[0], pixels.shape[1] // p
    # a stride-p convolution: the last rows and columns past side * p are not read
    patches = pixels[:, :side * p, :side * p].float().reshape(n, side, p, side, p, 3)
    patches = patches.permute(0, 1, 3, 5, 2, 4).reshape(n, side * side, 3 * p * p)
    x = linear(patches, W("vision_tower.patch_embedding.weight").reshape(d, -1),
               W("vision_tower.patch_embedding.bias"), precision)
    x = x + W("vision_tower.position_embedding")

    def layer(x, i):
        pre = f"vision_tower.layers.{i}"

        def lin(h, name):
            return linear(h, W(f"{pre}.{name}.weight"), W(f"{pre}.{name}.bias"), precision)

        h = F.layer_norm(x, (d,), W(f"{pre}.layer_norm1.weight"), W(f"{pre}.layer_norm1.bias"), eps)
        q, k, v = (lin(h, f"self_attn.{m}").view(n, -1, heads, d // heads).transpose(1, 2)
                   for m in ("q_proj", "k_proj", "v_proj"))
        att = torch.stack([attention(q[j], k[j], v[j], None) for j in range(n)])
        x = x + lin(att.transpose(1, 2).reshape(n, -1, d), "self_attn.out_proj")
        h = F.layer_norm(x, (d,), W(f"{pre}.layer_norm2.weight"), W(f"{pre}.layer_norm2.bias"), eps)
        return x + lin(F.gelu(lin(h, "mlp.fc1"), approximate="tanh"), "mlp.fc2")

    for i in range(vc["num_hidden_layers"]):
        x = checkpointed(layer, x, i, ckpt=ckpt)
    post = F.layer_norm(x, (d,), W("vision_tower.post_layernorm.weight"), W("vision_tower.post_layernorm.bias"), eps)
    return x, post


def projector(W: Weights, x, precision):
    h = F.gelu(linear(x, W("multi_modal_projector.linear_1.weight"), W("multi_modal_projector.linear_1.bias"),
                      precision))
    return linear(h, W("multi_modal_projector.linear_2.weight"), W("multi_modal_projector.linear_2.bias"),
                  precision)


def pack(model: dict, features: torch.Tensor, newline: torch.Tensor, size) -> torch.Tensor:
    """HF ``pack_image_features`` for one image: features [tiles, T, D] of
    the base tile then the grid row by row -> [tokens, D]."""
    vc = model["vision_config"]
    tile, side = vc["image_size"], vc["image_size"] // vc["patch_size"]
    nph, npw = anyres.grid_shape(size, model["image_grid_pinpoints"], tile)
    d = features.shape[-1]
    base, grid = features[0], features[1:1 + nph * npw]
    grid = grid.view(nph, npw, side, side, d).permute(4, 0, 2, 1, 3).reshape(d, nph * side, npw * side)
    r0, rows, c0, cols = anyres.unpad_rows_cols(size, nph * side, npw * side)
    grid = grid[:, r0:r0 + rows, c0:c0 + cols]
    ratio = math.sqrt(rows * cols / (anyres.max_patches(model) * side**2))
    if ratio > 1.1:
        grid = F.interpolate(grid[None], [int(rows // ratio), int(cols // ratio)], mode="bilinear")[0]
    grid = torch.cat([grid, newline[:, None, None].expand(d, grid.shape[1], 1)], dim=-1)
    return torch.cat([base, grid.flatten(1, 2).transpose(0, 1)], dim=0)


def forward(W: Weights, model: dict, ids, valid, pixels, frames, tiles, precision: str, ckpt: bool):
    """One stream of one micro-batch: ids, valid [B, S], pixels [B, P, H,
    W, 3], frames [B] (height, width), tiles [B] valid tiles -> (hidden [B,
    S, D], pooled post-layernorm features of the valid tiles [sum tiles, Dv])."""
    vc, tc = model["vision_config"], model["text_config"]
    flat = torch.cat([pixels[j, :tiles[j]] for j in range(len(tiles))])
    last, post = siglip(W, vc, flat, precision, ckpt)
    feats = projector(W, last, precision)
    emb = W("language_model.embed_tokens.weight")[ids]
    rows, off = [], 0
    newline = W("image_newline")
    for j, (size, nt) in enumerate(zip(frames, tiles)):
        packed = pack(model, feats[off:off + nt], newline, size)
        off += nt
        where = (ids[j] == model["image_token_index"]).nonzero()[:, 0]
        if where.numel() != packed.shape[0]:
            raise ValueError(f"{where.numel()} image tokens for {packed.shape[0]} packed features")
        rows.append(emb[j].index_put((where,), packed))
    hidden = lm.of(tc).forward(W, tc, torch.stack(rows), valid, precision, ckpt)
    return hidden, post.mean(dim=1)


# --- losses -----------------------------------------------------------------

def _second_best(p):
    first = p.argmax(-1, keepdim=True)
    return p.scatter(-1, first, float("-inf")).argmax(-1)


def _vocab_block(h, head, t, lab, lab_ce, terms, temperature, alpha, precision):
    """Sums over a block of rows: (loca, ce, kl), the terms not asked for 0.
    h [n, D], head [V, D], t [n, V] teacher logits at 1/T or None, lab the
    unshifted labels (LoCa), lab_ce the shifted ones (CE)."""
    s = linear(h, head, None, precision)
    zero = s.new_zeros(())
    loca = ce = kl = zero
    if "ce" in terms:
        ok = lab_ce != IGNORE
        gold = s.gather(1, lab_ce.clamp(min=0)[:, None])[:, 0]
        ce = ((torch.logsumexp(s, -1) - gold) * ok).sum()
    if "loca" in terms or "kl" in terms:
        log_ps = torch.log_softmax(s / temperature, -1)
        p_t = torch.softmax(t, -1)
    if "kl" in terms:
        log_pt = torch.log_softmax(t, -1)
        kl = (p_t * (log_pt - log_ps)).sum()
    if "loca" in terms:
        log_q = torch.log(torch.clamp(log_ps.exp(), min=1e-8))
        ok = lab >= 0
        safe = lab.clamp(min=0)
        p_gt = p_t.gather(1, safe[:, None])[:, 0]
        p_2 = p_t.gather(1, _second_best(p_t)[:, None])[:, 0]
        sc = alpha / (1.0 - p_gt + p_2)
        target = 1.0 - sc * (p_t.sum(-1) - p_gt)
        is_gt = torch.arange(p_t.shape[1], device=h.device)[None, :] == safe[:, None]
        cal = torch.where(is_gt, target[:, None], p_t * sc[:, None])
        cal = torch.where(ok[:, None], cal, p_t)
        pos = cal > 0
        loca = torch.where(pos, cal * (torch.log(torch.where(pos, cal, 1.0)) - log_q), 0.0).sum()
    return torch.stack([loca, ce, kl])


def vocab_sums(h, head, t, lab, lab_ce, terms, temperature=1.0, alpha=0.0, precision="float32", ckpt=True):
    """(loca, ce, kl) sums over all rows, block by block."""
    total = None
    for i in range(0, h.shape[0], ROW_BLOCK):
        sl = slice(i, i + ROW_BLOCK)
        part = checkpointed(_vocab_block, h[sl], head, None if t is None else t[sl], lab[sl], lab_ce[sl], terms,
                    temperature, alpha, precision, ckpt=ckpt)
        total = part if total is None else total + part
    return total


def ntxent(s_feat, t_feat, temperature):
    s = s_feat * torch.rsqrt((s_feat * s_feat).sum(-1, keepdim=True).clamp(min=1e-24))
    t = t_feat * torch.rsqrt((t_feat * t_feat).sum(-1, keepdim=True).clamp(min=1e-24))
    return -torch.log_softmax((s @ t.T) / temperature, dim=-1).diagonal().mean()


def shift_labels(labels):
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE)], dim=1)


def trains(name: str, job: dict) -> bool:
    """Whether the job trains parameter ``name``: double-trouble phase 1
    freezes the language model, phase 2 the vision tower."""
    root = name.split(".", 1)[0]
    if job["objective"] == "double_trouble" and job["phase"] == 1:
        return root != "language_model"
    if job["objective"] == "double_trouble" and job["phase"] == 2:
        return root != "vision_tower"
    return True


@torch.no_grad()
def teacher_logits(Wt: Weights, teacher: dict, vocab: int, inputs, a: int, temperature: float, precision):
    """The frozen teacher's logits at 1/T on the RGB stream of micro-batch
    ``a``, truncated to the student's vocab [B * S, vocab], and its pooled
    tile features."""
    hidden, feats = forward(Wt, teacher, inputs.input_ids[a], inputs.attention_mask[a].bool(),
                            inputs.pixels["teacher"][a], inputs.frames[a], [s.tiles for s in inputs.samples[a]],
                            precision, ckpt=False)
    h = hidden.reshape(-1, hidden.shape[-1])
    head = Wt.t["language_model.lm_head.weight"][:vocab]
    out = torch.empty(h.shape[0], vocab, device=h.device)
    for i in range(0, vocab, 1 << 15):
        out[:, i:i + (1 << 15)] = linear(h, head[i:i + (1 << 15)].float(), None, precision)
    return out.mul_(1.0 / temperature), feats


def micro_loss(Ws: Weights, Wt: Optional[Weights], config: dict, job: dict, inputs, a: int, precision: str,
               keep_teacher=None):
    """The job's loss on micro-batch ``a`` (a scalar with its graph) and its
    LoCa term (phase 3) or None.  ``keep_teacher(t)`` sees the teacher's
    logits at 1/T [B * S, vocab]."""
    st = config["student"]
    lc = job["loss"]
    tiles = [s.tiles for s in inputs.samples[a]]
    stream = "student"
    hidden, s_feat = forward(Ws, st, inputs.input_ids[a], inputs.attention_mask[a].bool(), inputs.pixels[stream][a],
                             inputs.frames[a], tiles, precision, ckpt=True)
    h = hidden.reshape(-1, hidden.shape[-1])
    head = Ws("language_model.embed_tokens.weight")
    labels = inputs.labels[a]
    lab, lab_ce = labels.reshape(-1), shift_labels(labels).reshape(-1)
    n, v = h.shape[0], head.shape[0]
    if job["objective"] == "baseline":
        sums = vocab_sums(h, head, None, lab, lab_ce, ("ce",), precision=precision)
        return sums[1] / (lab_ce != IGNORE).sum(), None
    temp = lc["temperature"]
    t, t_feat = teacher_logits(Wt, config["teacher"], v, inputs, a, temp, precision)
    if keep_teacher is not None:
        keep_teacher(t)
    if job["phase"] == 1:
        sums = vocab_sums(h, head, t, lab, lab_ce, ("kl",), temperature=temp, precision=precision)
        kl = sums[2] / (n * v) * temp**2
        con = ntxent(s_feat, t_feat, lc["ntxent_temperature"])
        return lc["soft_target_weight"] * kl + lc["contrastive_weight"] * con, None
    sums = vocab_sums(h, head, t, lab, lab_ce, ("loca", "ce"), temperature=temp, alpha=lc["loca_alpha"],
                      precision=precision)
    loca = sums[0] / (n * v) * temp**2
    ce = sums[1] / (lab_ce != IGNORE).sum()
    g = lc["gamma"]
    return g * (loca + ce) + (1.0 - g) * ce, loca.detach()


class AdamW:
    """Decoupled weight decay, then Adam with bias-corrected moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, eps, weight_decay):
        self.p, self.lr, self.b1, self.b2, self.eps, self.wd = params, lr, betas[0], betas[1], eps, weight_decay
        self.m = {n: torch.zeros_like(x) for n, x in params.items()}
        self.v = {n: torch.zeros_like(x) for n, x in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for n, p in self.p.items():
            g = grads[n]
            p.mul_(1 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


def train(config: dict, job: dict, traffic, steps: int, device, precision: str = "float32",
          load=None, log=print, half_probe: bool = False, backward: bool = True) -> dict:
    """Follow the program's first ``steps`` optimizer steps from the same
    weights and inputs.  ``load(stream, sink)`` hands the seeded weights
    (``portbench/weights.py``).  Returns per-step losses and LoCa terms
    (phase 3; each the mean over the micro-batches), step 1's teacher
    logits at ``traffic.check_rows`` (a KD job; one [rows, vocab] tensor on
    the host a micro-batch), each trained leaf's first-gradient norm and
    its change after ``steps`` steps; with ``half_probe``, the loss and
    gradient norms of step 1's first half of micro-batches alone (the "half
    the batch" fault).  ``backward=False`` runs step 1's forward alone and
    returns its loss, LoCa and teacher rows.

    Mixed precision as the configuration states it: AdamW updates float32
    masters (``master_dtype``), and each step's forward and backward read
    the masters rounded to the configuration's ``dtype`` (the weights a
    bf16 step computes with); every product and sum runs in float32 (or in
    float8 for the control)."""
    set_float32_exact()
    dtype = getattr(torch, config["dtype"])
    student: Dict[str, torch.Tensor] = {}
    masters: Dict[str, torch.Tensor] = {}

    def keep_student(name, x):
        if trains(name, job):
            masters[name] = x.float()
        else:
            student[name] = x.clone()

    load("student", keep_student)
    init = {n: m.clone() for n, m in masters.items()}
    Ws = Weights(student)
    Wt = None
    if config.get("teacher"):
        teacher: Dict[str, torch.Tensor] = {}
        load("teacher", lambda name, x: teacher.__setitem__(name, x.clone()))
        Wt = Weights(teacher)
    opt = AdamW(masters, job["learning_rate"], job["betas"], job["eps"], job["weight_decay"])
    a_n = traffic.accumulate
    losses: List[float] = []
    locas: List[float] = []
    out: dict = {}
    if Wt is not None:
        out["teacher"] = []
    if not backward:
        steps = 1
    for k in range(steps):
        trained = {n: m.to(dtype).to(torch.float32, copy=True).requires_grad_(backward)
                   for n, m in masters.items()}
        student.update(trained)
        inputs = traffic.make(k, device)
        total = loca_total = 0.0
        for a in range(a_n):
            keep = None
            if k == 0 and Wt is not None:
                rows = traffic.check_rows(0, a).to(device)
                keep = lambda t, rows=rows: out["teacher"].append(t[rows].cpu())  # noqa: E731
            with torch.set_grad_enabled(backward):
                loss, loca = micro_loss(Ws, Wt, config, job, inputs, a, precision, keep)
            if backward:
                loss.backward()
            total += loss.item()
            if loca is not None:
                loca_total += loca.item()
            if half_probe and k == 0 and a == a_n // 2 - 1:
                out["half_loss"] = total / (a + 1)
                out["half_grad"] = {n: 0.0 if p.grad is None else (p.grad / (a + 1)).norm().item()
                                    for n, p in trained.items()}
        del inputs
        if loca is not None:
            locas.append(loca_total / a_n)
        if not backward:
            out["loss"] = [total / a_n]
            if locas:
                out["loca"] = locas
            log(f"[reference] step 1 forward: loss {out['loss'][0]:.8f}")
            return out
        # a leaf no loss reads (phase 3's post-layernorm) gets a zero gradient
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad / a_n for n, p in trained.items()}
        if k == 0:
            out["grad"] = {n: g.norm().item() for n, g in grads.items()}
        opt.step(grads)
        del grads, trained
        losses.append(total / a_n)
        log(f"[reference] step {k + 1}: loss {losses[-1]:.8f}")
    out["loss"] = losses
    if locas:
        out["loca"] = locas
    out["change"] = {n: (m - init[n]).norm().item() for n, m in masters.items()}
    return out
