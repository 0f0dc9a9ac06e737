"""Plain float32 references of the benchmark's configurations.

Plain PyTorch, written from the published architectures and losses, with
no kernel, cache or batching trick of the port: ``anyres`` (the HF LLaVA
OneVision image geometry), ``llava_onevision`` (SigLIP, the projector, the
anyres pack, the losses and AdamW), ``lm/<model_type>.py`` (each language
model: ``lm/qwen2.py``) and ``layers`` (the operations they share).
Nothing here imports JAX or the port, and nothing takes a tensor the port
made: the weights and inputs come from ``portbench/weights.py`` and
``portbench/traffic.py``, from the seed.
"""
