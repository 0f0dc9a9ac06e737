"""PyTorch/CUDA port of the kdss framework for one NVIDIA H100.

The JAX package ``knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu``
is the reference; this package mirrors its layout module by module so each
counterpart is easy to find.  It imports ``torch`` and nothing of the JAX
package -- not jax, flax, optax or orbax, and not even the JAX package's
jax-free modules: it keeps its own copies of the host layer it needs
(configs, anyres packing, chat templates, tokenization, image processing,
collation, the loader, synthetic batches, number words, the HF weight
mapping).  Only the tests import both, to hold the port to the reference.

Covered so far: greedy generation with the 0.5B depth student -- the SigLIP
tower, the projector and anyres packing, the Qwen2 LM with a KV cache, the
``Generator``, and the inference CLI; its baseline_depth training -- masked
CE over the fused route, the train and eval steps with gradient
accumulation, AdamW over float32 masters, checkpoints, the epoch loop and
the train CLI; online KD against the frozen 7B teacher -- every KD mode
and phase (LoCa + CE; KL + NT-Xent), the phase hand-off and the KD CLI;
int8 (w8a8) serving and the int8 teacher; and the evaluator (batched
generation over a split, checkpoint restore, the reference's predictions
CSV and metrics summary).  The kernels on those paths
are hand-written CUDA for Hopper: the flash-attention forward (D = 64, 72
and 128) and backward (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, bound
in ``ops/flash_attention.py``), the vocab-streaming cross-entropy
(``csrc/fused_ce.cu``, ``ops/fused_ce.py``), the combined LoCa + CE
(``csrc/fused_loca_ce.cu``, ``ops/fused_loca.py``), the temperature KL
(``csrc/fused_kl.cu``, ``ops/fused_kl.py``), and, for int8 serving and the
int8 teacher, the w8a8 GEMM (``csrc/int8_mm.cu``, ``ops/int8.py``) and the
teacher's logits from its int8 head (``csrc/tmat_int8.cu``); and the
flash forward's phase-ablation arms, a profiling instrument
(``csrc/flash_phase_ablation*.cu``, the template parameter of
``csrc/flash_gqa_sm90.cuh``; ``ops/flash_phase_ablation.py``).
"""

__version__ = "0.1.0"
