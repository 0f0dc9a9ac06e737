"""Shared CLI plumbing (port of the JAX package's ``cli/common.py``).

The jax-free helpers — ``.env`` loading, tiny/real config choice, the
tokenizer, the synthetic dataset tree — are the JAX package's own, imported
as they are.  Written here: the flags this port implements, device set-up,
``resolve_attn_impl``, ``make_datasets`` and ``init_or_load_params``.
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


def add_reference_flags(p: argparse.ArgumentParser, accum_default: int = 64) -> None:
    """The six reference CLI flags (`phase1/train_online_kd.py:65-70`)."""
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_epochs", type=int, default=1)
    p.add_argument("--subset_percentage", type=float, default=None)
    p.add_argument("--load_checkpoint", action="store_true")
    p.add_argument("--augmentation", action="store_true")
    p.add_argument("--accumulate_grad_batches", type=int, default=accum_default)


def add_train_flags(p: argparse.ArgumentParser) -> None:
    """The JAX trainers' data, checkpoint and logging flags that this port
    implements."""
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--tensorboard_dir", type=str, default="tensorboard_logs")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--depth_encoding", type=str, default="prewitt",
                   choices=["prewitt", "gray3", "prewitt_imagenet"])
    p.add_argument("--train_csv", type=str, default="train_dataset.csv")
    p.add_argument("--val_csv", type=str, default="val_dataset.csv")
    p.add_argument("--dataset", type=str, default="sunrgbd", choices=["sunrgbd", "daquar"])


def make_datasets(args, root: str):
    """(train_ds, val_ds) on the port's jax-free SUNRGBD reader.  DAQUAR is
    refused until its reader is ported."""
    if args.dataset == "daquar":
        raise SystemExit(
            "--dataset daquar is not ported yet: its reader waits for the host-layer "
            "item of ROADMAP.md queue 1 (the reference's data/dataset.py imports jax)"
        )
    from ..data.dataset import SUNRGBDVQADataset

    return (
        SUNRGBDVQADataset(root, args.train_csv, args.subset_percentage,
                          depth_encoding=args.depth_encoding),
        SUNRGBDVQADataset(root, args.val_csv, args.subset_percentage,
                          depth_encoding=args.depth_encoding),
    )


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
    """The model's (compute) dtype: bf16 on CUDA (as the JAX CLI computes in
    bf16 on the TPU), f32 on the CPU.  Training keeps float32 masters of
    bf16 parameters in the optimizer (``train/optimizer.py``)."""
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
    trainable: bool = False,
) -> LlavaOnevision:
    """Build the model on ``device``: weights from a local HF snapshot, or a
    seeded random init.  Weights are made in f32, then cast to ``dtype``.
    ``trainable=False`` (serving) freezes them in eval mode; ``True`` gives a
    model in train mode whose parameters require grad."""
    model = LlavaOnevision(cfg, attn_impl=attn_impl, device=device, dtype=torch.float32)
    if weights_path:
        from ..models.convert import load_llava_onevision_params

        model.load_state_dict(load_llava_onevision_params(weights_path, cfg))
    else:
        init_weights(model, seed)
    model = model.to(dtype).requires_grad_(trainable)
    return model.train() if trainable else model.eval()
