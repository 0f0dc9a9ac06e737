"""Model / data / train configuration dataclasses and presets (the port's
copy of the JAX package's ``configs.py``).

The reference hardcodes HF model names (``llava-hf/llava-onevision-qwen2-0.5b-ov-hf``
student, ``...-7b-ov-hf`` teacher) and scatters hyperparameters across Lightning
module ``__init__``s (e.g. ``distillation/knowledge_distillation7b_double_trouble/
phase1/OnlineKnowledgeDistillationLLavaOneVision.py:67-71``).  Here every
experiment is a single frozen dataclass, jit-hashable and explicit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _grid_pinpoints(max_grid: int = 6, base: int = 384) -> Tuple[Tuple[int, int], ...]:
    """All (h, w) anyres pinpoints from 1x1 .. max_grid x max_grid tiles of `base`.

    Matches the `image_grid_pinpoints` list in the HF LLaVA-OneVision configs.
    """
    return tuple(
        (base * i, base * j)
        for i in range(1, max_grid + 1)
        for j in range(1, max_grid + 1)
    )


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    """SigLIP vision tower config (SigLIP-SO400M-patch14-384 preset)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 26
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_tanh"

    @property
    def tokens_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_patch(self) -> int:
        s = self.tokens_per_side
        return s * s

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder-only LM config."""

    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    attention_bias: bool = True  # qkv bias, no o bias (Qwen2 style)


@dataclasses.dataclass(frozen=True)
class LlavaOnevisionConfig:
    """Full multimodal model config.

    Mirrors the fields of the HF ``LlavaOnevisionConfig`` that the reference
    relies on (vision_feature_select_strategy="full", vision_feature_layer=-1,
    vision_aspect_ratio="anyres_max_9").
    """

    vision: SigLIPVisionConfig = SigLIPVisionConfig()
    text: Qwen2Config = Qwen2Config()
    image_token_id: int = 151646
    video_token_id: int = 151647
    pad_token_id: int = 151645  # falls back to eos, as in the reference
    eos_token_id: int = 151645
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = _grid_pinpoints()
    vision_aspect_ratio_max: int = 9  # "anyres_max_9"
    projector_bias: bool = True

    # Static-shape budget: maximum anyres tiles per image kept on device
    # (base tile + up to a 3x3 grid covers every SUNRGBD image; larger
    # grids are truncated by the host-side packer).
    max_tiles: int = 10

    @property
    def max_image_tokens(self) -> int:
        """Upper bound of packed image-feature tokens per image.

        base (729) + anyres_max_9 capped grid (<= 9 * 729 scaled) + newline
        rows.  With anyres_max_9 the packed grid after downsampling has at
        most ~`9 * 729` cells; rows add one newline each.
        """
        t = self.vision.tokens_per_side  # 27
        # base + max grid tokens + max newline rows (see eval in packing.py)
        return self.vision.tokens_per_patch + self.vision_aspect_ratio_max * t * t + 3 * t + 84


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def llava_onevision_0_5b() -> LlavaOnevisionConfig:
    """llava-hf/llava-onevision-qwen2-0.5b-ov-hf (student)."""
    return LlavaOnevisionConfig(
        vision=SigLIPVisionConfig(),
        text=Qwen2Config(
            vocab_size=151936,
            hidden_size=896,
            intermediate_size=4864,
            num_hidden_layers=24,
            num_attention_heads=14,
            num_key_value_heads=2,
            head_dim=64,
            tie_word_embeddings=True,
        ),
    )


def llava_onevision_7b() -> LlavaOnevisionConfig:
    """llava-hf/llava-onevision-qwen2-7b-ov-hf (teacher)."""
    return LlavaOnevisionConfig(
        vision=SigLIPVisionConfig(),
        text=Qwen2Config(
            vocab_size=152128,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            head_dim=128,
            tie_word_embeddings=False,
        ),
    )


def llava_onevision_tiny_teacher(student_vocab: int = 512) -> LlavaOnevisionConfig:
    """Tiny teacher: larger (untied) vocab + wider LM than the tiny student,
    sharing the student's special-token ids — mirrors the real 7B/0.5B
    vocab mismatch (152128 vs 151936) that motivates logit truncation."""
    base = llava_onevision_tiny(student_vocab)
    return dataclasses.replace(
        base,
        text=dataclasses.replace(
            base.text,
            vocab_size=student_vocab + 64,
            hidden_size=48,
            intermediate_size=96,
            num_attention_heads=6,
            num_key_value_heads=2,
            head_dim=8,
            tie_word_embeddings=False,
        ),
    )


def llava_onevision_tiny(vocab_size: int = 512) -> LlavaOnevisionConfig:
    """Tiny config for unit tests / CPU parity checks against HF torch."""
    return LlavaOnevisionConfig(
        vision=SigLIPVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=28,
            patch_size=14,
        ),
        text=Qwen2Config(
            vocab_size=vocab_size,
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=8,
            tie_word_embeddings=True,
        ),
        image_token_id=vocab_size - 3,
        video_token_id=vocab_size - 2,
        pad_token_id=vocab_size - 1,
        eos_token_id=vocab_size - 1,
        image_grid_pinpoints=_grid_pinpoints(max_grid=3, base=28),
        max_tiles=11,
    )


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KDLossConfig:
    """Distillation loss hyperparameters.

    Defaults follow the reference double-trouble module
    (`phase1/OnlineKnowledgeDistillationLLavaOneVision.py:67-71`):
    soft_target_weight=0.1, ce/contrastive weight=0.5, gamma=0.8, T=0.8,
    LoCa alpha=0.8, NT-Xent temperature=0.07.
    """

    soft_target_weight: float = 0.1
    ce_weight: float = 0.5
    contrastive_weight: float = 0.5
    gamma: float = 0.8
    temperature: float = 0.8
    loca_alpha: float = 0.8
    ntxent_temperature: float = 0.07
    # Reference's LoCa uses full-tensor fancy indexing rather than
    # per-position scatter (SURVEY.md §2.5 #3).  `faithful` replicates that;
    # False uses the paper-correct per-position calibration.
    loca_faithful_indexing: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training experiment (flag-parity with the reference CLIs)."""

    # Reference CLI flags (phase1/train_online_kd.py:65-70)
    batch_size: int = 1
    max_epochs: int = 1
    subset_percentage: Optional[float] = None
    load_checkpoint: bool = False
    augmentation: bool = False
    accumulate_grad_batches: int = 64

    # Optimizer (logit_based/...:279-282 -> AdamW 1e-5 + cosine T_max=10;
    # baselines use 2e-5)
    learning_rate: float = 1e-5
    cosine_t_max: int = 10
    weight_decay: float = 0.01

    # KD strategy: "baseline" | "logit_based" | "feature_based" | "double_trouble"
    kd_mode: str = "double_trouble"
    phase: int = 1
    loss: KDLossConfig = KDLossConfig()

    # Stream routing: baseline trains on "depth" or "rgb" pixels
    pixel_stream: str = "depth"

    # Numerics / TPU
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Gradient-accumulation carry dtype (train/step.py): "float32" sums
    # micro-grads exactly then divides (torch-master-grad semantics; a
    # full f32 param-shaped buffer — 2 GB for the 0.5B student, the
    # measured accum>=4 OOM on one 16 GiB chip at the 7B KD workload);
    # "bfloat16" / "param" carry the RUNNING MEAN in reduced precision
    # (each micro-grad pre-scaled by 1/A so magnitudes stay uniform;
    # bf16's 8-bit mantissa costs ~2^-8 relative noise per add — the
    # accum-vs-accum=1 loss-trace drift is pinned in
    # tests/test_train_step.py and measured in docs/PERF_NOTES.md)
    accum_dtype: str = "float32"
    # Sequence-chunk size for the never-materialized KD loss scan
    loss_chunk_size: int = 256
    # CE implementation: "chunked" (XLA scan) or "fused" (Pallas
    # vocab-streaming kernel; TPU only, baseline/CE-only path)
    ce_impl: str = "chunked"
    # Per-shard impl inside the mesh-sharded fused losses
    # (ops/fused_spmd.py): "pallas" (production TPU) or "xla" (CPU-mesh
    # tests; interpret-mode Pallas hangs inside shard_map on CPU)
    fused_local_impl: str = "pallas"

    # Mesh axes (data, fsdp, tensor); product must equal device count
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)

    seed: int = 0


def kd_loss_config_for(kd_mode: str) -> KDLossConfig:
    """Per-strategy loss hyperparameters as hardcoded in the reference
    module ``__init__``s.

    * logit_based: LoCa alpha=0.8, T=1 (`logit_based/...:75,208`)
    * feature_based: 0.1*KL(T=0.8) + 0.8*CE + 1.0*contrastive
      (`feature_based/...:72-74,191-230`)
    * double_trouble: 0.1*KL + 0.5*contrastive (p1), LoCa+CE (p2),
      gamma=0.8 mix (p3), T=0.8 (`phase1/...:67-71`)
    """
    if kd_mode == "logit_based":
        return KDLossConfig(temperature=1.0)
    if kd_mode == "feature_based":
        return KDLossConfig(ce_weight=0.8, contrastive_weight=1.0, temperature=0.8)
    return KDLossConfig()
