"""Shared CLI plumbing (port of the JAX package's ``cli/common.py``).

The jax-free helpers — ``.env`` loading, tiny/real config choice, the
tokenizer, the synthetic dataset tree — are the JAX package's own, imported
as they are.  Written here: device set-up, ``resolve_attn_impl`` and
``init_or_load_params``.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli.common import (  # noqa: F401
    ensure_synthetic_dataset,
    is_tiny,
    load_env,
    make_tokenizer,
    model_configs,
)

from ..models.llava_onevision import LlavaOnevision, init_weights

ATTN_IMPLS = ("xla", "flash")


def add_device_flags(p: argparse.ArgumentParser) -> None:
    """The JAX package's platform/model flags that this port implements."""
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--synthetic_data", action="store_true",
                   help="generate a tiny on-disk SUNRGBD tree + hash tokenizer "
                        "(no real dataset/weights needed)")
    p.add_argument("--real_model", action="store_true",
                   help="use the real 0.5B/7B configs even with --synthetic_data")
    p.add_argument("--tiny_model", action="store_true",
                   help="tiny configs (CI/smoke); default with --synthetic_data")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--student_weights", type=str, default=None,
                   help="local HF snapshot dir for the 0.5B student")
    p.add_argument("--attn_impl", type=str, default=None, choices=ATTN_IMPLS,
                   help="default: flash on CUDA, xla on the CPU")
    p.add_argument("--seed", type=int, default=0)


def setup_device(args) -> torch.device:
    """``cuda:0`` unless ``--cpu``.  Without a CUDA device and without
    ``--cpu`` this raises: nothing carries on on the CPU in its place."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --cpu to run on the CPU")
    # Full-f32 references on the card: matmuls are f32 by default, but
    # cuDNN convolutions (the patch embed) default to TF32.  Set both.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def model_dtype(device: torch.device) -> torch.dtype:
    """bf16 on CUDA (as the JAX CLI runs bf16 on the TPU), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def resolve_attn_impl(args, device: torch.device) -> str:
    """``--attn_impl`` if given, else the kernel arm on CUDA and the plain
    path on the CPU (the JAX package picks "pallas" on a TPU, "xla" on CPU)."""
    if args.attn_impl:
        return args.attn_impl
    return "flash" if device.type == "cuda" else "xla"


def init_or_load_params(
    cfg,
    weights_path: Optional[str],
    seed: int,
    *,
    attn_impl: str,
    device: torch.device,
    dtype: torch.dtype,
) -> LlavaOnevision:
    """Build the model on ``device``: weights from a local HF snapshot, or a
    seeded random init.  Weights are made in f32, then cast to ``dtype``."""
    model = LlavaOnevision(cfg, attn_impl=attn_impl, device=device, dtype=torch.float32)
    if weights_path:
        from ..models.convert import load_llava_onevision_params

        model.load_state_dict(load_llava_onevision_params(weights_path, cfg))
    else:
        init_weights(model, seed)
    return model.to(dtype).eval().requires_grad_(False)
