"""The system under test: the port's training step, built from a
configuration and a job, and its counters.

The only module of the benchmark that imports the port
(``knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch``).
It builds the port's ``LlavaOnevision`` models with the flash kernels, loads
the seeded weights (``portbench/weights.py``) into them, and drives
``train/step.py::make_train_step`` with ``train/optimizer.py``'s AdamW over
float32 masters, the vocabulary terms on the fused kernels
(``ce_impl="fused"``).  The batch is what the port's collate would hand the
step: the generator's ids, masks, labels and pixels, and the anyres pack
spec from the port's own ``data/anyres.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
from typing import Callable, Dict

import numpy as np
import torch

from . import weights as seeded

PORT = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch"


@functools.lru_cache(maxsize=None)
def _port():
    import importlib

    names = ("configs", "data.anyres", "models.llava_onevision", "train.optimizer", "train.step",
             "ops.flash_attention", "ops.fused_ce", "ops.fused_kl", "ops.fused_loca")
    return {n: importlib.import_module(f"{PORT}.{n}") for n in names}


def port_config(model: dict, max_tiles: int):
    """The port's ``LlavaOnevisionConfig`` at this model section's sizes."""
    c = _port()["configs"]
    vc, tc = model["vision_config"], model["text_config"]
    vision = c.SigLIPVisionConfig(
        hidden_size=vc["hidden_size"], intermediate_size=vc["intermediate_size"],
        num_hidden_layers=vc["num_hidden_layers"], num_attention_heads=vc["num_attention_heads"],
        image_size=vc["image_size"], patch_size=vc["patch_size"], layer_norm_eps=vc["layer_norm_eps"])
    text = c.Qwen2Config(
        vocab_size=tc["vocab_size"], hidden_size=tc["hidden_size"], intermediate_size=tc["intermediate_size"],
        num_hidden_layers=tc["num_hidden_layers"], num_attention_heads=tc["num_attention_heads"],
        num_key_value_heads=tc["num_key_value_heads"], head_dim=seeded.head_dim(tc),
        rms_norm_eps=tc["rms_norm_eps"], rope_theta=tc["rope_theta"],
        tie_word_embeddings=tc["tie_word_embeddings"])
    return c.LlavaOnevisionConfig(
        vision=vision, text=text, image_token_id=model["image_token_index"], pad_token_id=model["pad_token_id"],
        eos_token_id=model["pad_token_id"], image_grid_pinpoints=tuple(map(tuple, model["image_grid_pinpoints"])),
        vision_aspect_ratio_max=int(model["vision_aspect_ratio"].removeprefix("anyres_max_")),
        projector_bias=model["multimodal_projector_bias"], max_tiles=max_tiles)


class System:
    """The port's models, optimizer and step for one cell."""

    @staticmethod
    def import_port() -> None:
        _port()

    def __init__(self, config: dict, job: dict, seed: int, device, attn_impl: str = "flash"):
        p = _port()
        self.p, self.job, self.device = p, job, device
        dtype = getattr(torch, config["dtype"])
        self.cfg = port_config(config["student"], config["max_tiles"])
        self.student = self._build(self.cfg, config, "student", seed, device, dtype, attn_impl, trainable=True)
        self.teacher = None
        if job["objective"] != "baseline":
            tcfg = port_config(config["teacher"], config["max_tiles"])
            self.teacher = self._build(tcfg, config, "teacher", seed, device, dtype, attn_impl, trainable=False)
        kd_mode, phase = job["objective"], job["phase"]
        opt = p["train.optimizer"].make_optimizer(
            self.student, job["learning_rate"], weight_decay=job["weight_decay"], cosine_t_max=0,
            kd_mode=kd_mode, phase=phase, b1=job["betas"][0], b2=job["betas"][1], eps=job["eps"])
        loss = dataclasses.replace(p["configs"].kd_loss_config_for(kd_mode), **job["loss"])
        tcfg = p["configs"].TrainConfig(kd_mode=kd_mode, phase=phase, loss=loss, ce_impl="fused",
                                        learning_rate=job["learning_rate"], cosine_t_max=0,
                                        weight_decay=job["weight_decay"])
        st = p["train.step"]
        self.state = st.TrainState(self.student, opt)
        self.step_fn = st.make_train_step(st.KDModels(self.student, self.teacher), tcfg)
        self._packs: Dict[tuple, tuple] = {}

    @staticmethod
    def _build(cfg, config, stream, seed, device, dtype, attn_impl, trainable):
        lo = _port()["models.llava_onevision"]
        with torch.device("meta"):
            model = lo.LlavaOnevision(cfg, attn_impl=attn_impl, dtype=dtype)
        model = model.to_empty(device=device)
        params = dict(model.named_parameters())
        seen = set()

        def sink(name, x):
            params[name].data.copy_(x)
            seen.add(name)

        with torch.no_grad():
            seeded.generate(config[stream], seed, stream, device, sink, dtype)
        missing = set(params) - seen
        if missing:
            raise ValueError(f"{stream}: no seeded weight for {sorted(missing)[:4]}")
        if any(True for _ in model.buffers()):
            raise ValueError(f"{stream}: the model holds buffers the seeded weights do not fill")
        model.requires_grad_(trainable)
        return model.train() if trainable else model.eval()

    def _pack(self, size):
        if size not in self._packs:
            an, c, v = self.p["data.anyres"], self.cfg, self.cfg.vision
            self._packs[size] = an.build_pack_spec(size, c.image_grid_pinpoints, v.image_size, v.tokens_per_side,
                                                   c.vision_aspect_ratio_max, c.max_tiles, c.max_image_tokens)
        return self._packs[size]

    def batch(self, inputs) -> Dict[str, torch.Tensor]:
        """The step's batch (leading axis A) from the generator's inputs."""
        specs = [[self._pack(hw) for hw in row] for row in inputs.frames]
        idx = np.stack([np.stack([s.idx for s in row]) for row in specs])
        w = np.stack([np.stack([s.weight for s in row]) for row in specs])
        valid = np.stack([np.stack([s.valid for s in row]) for row in specs])
        tiles = np.zeros(idx.shape[:2] + (self.cfg.max_tiles,), dtype=bool)
        for i, row in enumerate(specs):
            for j, s in enumerate(row):
                tiles[i, j, :s.n_tiles] = True
        dev = self.device
        b = {"student_input_ids": inputs.input_ids, "student_attention_mask": inputs.attention_mask,
             "student_pixel_values": inputs.pixels["student"], "labels": inputs.labels,
             "pack_idx": torch.from_numpy(idx).to(dev), "pack_weight": torch.from_numpy(w).to(dev),
             "pack_valid": torch.from_numpy(valid).to(dev), "tile_valid": torch.from_numpy(tiles).to(dev)}
        if self.teacher is not None:
            b.update(teacher_input_ids=inputs.input_ids, teacher_attention_mask=inputs.attention_mask,
                     teacher_pixel_values=inputs.pixels["teacher"])
        return b

    def step(self, batch) -> Dict[str, torch.Tensor]:
        self.state, metrics = self.step_fn(self.state, None, batch)
        return metrics

    @contextlib.contextmanager
    def teacher_rows(self, rows_of: Callable[[int], torch.Tensor]):
        """While open, keeps the rows ``rows_of(a)`` of the float32 teacher
        logits at 1/T that micro-batch ``a`` of the step hands its loss, on
        the host (None where the logits lack a row)."""
        st = self.p["train.step"]
        inner, kept = st._teacher_logits, []

        def keep(teacher, batch, vocab, temperature):
            t, vis = inner(teacher, batch, vocab, temperature)
            rows = rows_of(len(kept))
            kept.append(t[rows.to(t.device)].cpu() if int(rows.max()) < t.shape[0] else None)
            return t, vis

        st._teacher_logits = keep
        try:
            yield kept
        finally:
            st._teacher_logits = inner

    @property
    def masters(self) -> Dict[str, torch.Tensor]:
        return self.state.optimizer.masters

    @torch.no_grad()
    def first_grad_norms(self) -> Dict[str, float]:
        """Each trained leaf's gradient as AdamW got it, from its state after
        one update: exp_avg / (1 - beta1)."""
        opt = self.state.optimizer.opt
        b1 = opt.param_groups[0]["betas"][0]
        return {n: (opt.state[m]["exp_avg"].norm() / (1 - b1)).item() if m in opt.state else 0.0
                for n, m in self.masters.items()}

    # --- the port's launch counters ----------------------------------------

    def counters(self) -> Dict[str, int]:
        fa, fc, fk, fl = (self.p[n] for n in ("ops.flash_attention", "ops.fused_ce", "ops.fused_kl",
                                              "ops.fused_loca"))
        out = {"flash_fwd_d72": fa.flash_attention.head_dim_launches.get(72, 0),
               "flash_bwd_d72": fa.flash_attention_bwd.head_dim_launches.get(72, 0),
               "flash_fwd_d64": fa.flash_attention_gqa.head_dim_launches.get(64, 0),
               "flash_fwd_d128": fa.flash_attention_gqa.head_dim_launches.get(128, 0),
               "flash_bwd_d64": fa.flash_attention_gqa_bwd.head_dim_launches.get(64, 0),
               "ce_fwd": fc.lse_gold_fwd.launches, "ce_bwd": fc.lse_gold_bwd.launches,
               "kl_fwd": fk.kl_fwd.launches, "kl_bwd": fk.kl_bwd.launches, "kl_bwd_dw": fk.kl_bwd.dw_launches,
               "loca_ce_fwd": fl.loca_ce_fwd.launches, "loca_ce_bwd": fl.loca_ce_bwd.launches}
        return out

    def free(self) -> None:
        self.state = self.step_fn = self.student = self.teacher = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
