"""PyTorch/CUDA port of the kdss framework for one NVIDIA H100.

The JAX package ``knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu``
is the reference; this package mirrors its layout module by module so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``,
``flax`` or ``optax``.  The JAX package's jax-free host modules (configs,
anyres packing, chat templates, tokenization, collation, synthetic batches,
the HF -> numpy weight mapping) are imported from there, not copied.

Covered so far: greedy generation with the 0.5B depth student — the SigLIP
tower, the projector and anyres packing, the Qwen2 LM with a KV cache, the
``Generator``, and the inference CLI — and its baseline_depth training —
masked CE over the fused route, the train and eval steps with gradient
accumulation, AdamW, checkpoints, the epoch loop and the train CLI.  The
kernels on those paths are hand-written CUDA for Hopper: the flash-attention
forward and backward (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, bound in
``ops/flash_attention.py``) and the vocab-streaming cross-entropy
(``csrc/fused_ce.cu``, bound in ``ops/fused_ce.py``).
"""

__version__ = "0.1.0"
