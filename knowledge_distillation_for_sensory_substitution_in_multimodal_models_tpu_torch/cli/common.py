"""Shared CLI plumbing (port of the JAX package's ``cli/common.py``):
``.env`` loading, the flags this port implements, tiny/real config choice,
the tokenizer, the synthetic SUNRGBD and DAQUAR trees, device set-up, the
attention and loss routes (``resolve_attn_impl``, ``resolve_ce_impl``),
``make_datasets`` and ``init_or_load_params``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import (
    llava_onevision_0_5b,
    llava_onevision_7b,
    llava_onevision_tiny,
    llava_onevision_tiny_teacher,
)
from ..models.llava_onevision import LlavaOnevision, init_weights

ATTN_IMPLS = ("xla", "flash")
# --quant / --teacher_quant: "int8" quantizes the LM's decoder-block
# projections, "int8_full" the SigLIP encoder's too (w8a8, ops/int8.py).
QUANT_MODES = ("none", "int8", "int8_full")


def load_env(path: str = ".env") -> dict:
    """KEY=VALUE lines of ``path`` (the reference's python-dotenv file) into
    ``os.environ`` where unset; returns them."""
    env = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                env[k.strip()] = v.strip().strip("'\"")
                os.environ.setdefault(k.strip(), env[k.strip()])
    return env


def is_tiny(args) -> bool:
    """Tiny-config mode: smoke/synthetic runs unless --real_model."""
    return (args.synthetic_data or args.tiny_model) and not getattr(args, "real_model", False)


def model_configs(args) -> Tuple:
    """(student, teacher) configs: the tiny pair or the 0.5B / 7B pair."""
    if is_tiny(args):
        return llava_onevision_tiny(), llava_onevision_tiny_teacher()
    return llava_onevision_0_5b(), llava_onevision_7b()


def make_tokenizer(args, cfg):
    """``--tokenizer_path`` (HF, local), else the hash tokenizer; a tiny
    vocab gets its special ids squashed into range."""
    from ..data.tokenization import HashTokenizer, get_tokenizer

    if args.tokenizer_path:
        return get_tokenizer(args.tokenizer_path)
    tok = HashTokenizer(
        vocab_size=cfg.text.vocab_size,
        pad_token_id=cfg.pad_token_id,
        eos_token_id=cfg.eos_token_id,
        image_token_id=cfg.image_token_id,
    )
    if cfg.text.vocab_size < 152_000:
        tok.SPECIALS = {
            "<|im_start|>": cfg.text.vocab_size - 6,
            "<|im_end|>": cfg.pad_token_id,
            "<image>": cfg.image_token_id,
            "<video>": cfg.video_token_id,
        }
        vocab = cfg.text.vocab_size

        def _wid(w, _tok=tok, _vocab=vocab):
            if w in _tok.SPECIALS:
                return _tok.SPECIALS[w]
            wid = _tok._cache.get(w)
            if wid is None:
                h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "big")
                wid = h % (_vocab - 8)
                # keep the reverse map populated so decode() renders seen words
                _tok._cache[w] = wid
                _tok._rev.setdefault(wid, w)
            return wid

        tok._word_id = _wid
    return tok


def ensure_synthetic_dataset(root: str, n: int = 12, seed: int = 0, size=None) -> str:
    """Write a tiny SUNRGBD-layout tree (csv_data + images) under ``root``;
    ``size=(h, w)`` pins every image to one resolution."""
    import pandas as pd
    from PIL import Image

    sun = os.path.join(root, "SUNRGBD")
    os.makedirs(os.path.join(sun, "csv_data"), exist_ok=True)
    os.makedirs(os.path.join(sun, "img"), exist_ok=True)
    rng = np.random.default_rng(seed)
    answers = ["chair", "table", "bed", "two", "yes", "red"]
    qtypes = ["Object Identification", "Object Identification", "Object Identification",
              "Count", "Yes/No", "Color"]
    rows = []
    for i in range(n):
        h, w = size if size is not None else [(45, 67), (30, 80), (52, 52)][i % 3]
        rgb = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
        depth = rng.integers(0, 65535, size=(h, w)).astype(np.uint16)
        Image.fromarray(rgb).save(os.path.join(sun, "img", f"rgb_{i}.png"))
        Image.fromarray(depth).save(os.path.join(sun, "img", f"d_{i}.png"))
        rows.append({
            "Question_Id": i,
            "Questions": f"what is the object number {i}?",
            "Answers": answers[i % len(answers)],
            "Image_Path": f"SUNRGBD/img/rgb_{i}.png",
            "Depth_Path": f"SUNRGBD/img/d_{i}.png",
            "Question_Type": qtypes[i % len(qtypes)],
        })
    df = pd.DataFrame(rows)
    for split in ("train_dataset.csv", "val_dataset.csv", "test_dataset.csv"):
        df.to_csv(os.path.join(sun, "csv_data", split), index=False)
    return root


def ensure_synthetic_daquar(root: str, n: int = 8, seed: int = 0) -> str:
    """Write a tiny DAQUAR-layout tree under ``root``: images/<name>.png and
    depth/<name>_depth.png, the three split CSVs at the root."""
    import pandas as pd
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        h, w = [(48, 64), (40, 56)][i % 2]
        name = f"image{i}"
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(root, "images", f"{name}.png"))
        Image.fromarray(rng.integers(0, 65535, (h, w)).astype(np.uint16)).save(
            os.path.join(root, "depth", f"{name}_depth.png"))
        rows.append({
            "Question_Id": i,
            "Questions": f"what is in the image {i}?",
            "Answers": ["chair", "table"][i % 2],
            "Image_Path": f"{name}.png",
            "Depth_Path": f"{name}_depth.png",
        })
    df = pd.DataFrame(rows)
    for split in ("train_dataset.csv", "val_dataset.csv", "test_dataset.csv"):
        df.to_csv(os.path.join(root, split), index=False)
    return root


def data_root(args) -> str:
    """``--root_data_dir``, else ROOT_DATA_DIR; with ``--synthetic_data`` a
    synthetic tree of ``--dataset``'s layout written there (a fresh
    temporary directory if neither is set)."""
    import tempfile

    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        root = root or tempfile.mkdtemp(prefix="kdss_synth_")
        make = ensure_synthetic_daquar if args.dataset == "daquar" else ensure_synthetic_dataset
        root = make(root)
    if not root:
        raise SystemExit("set ROOT_DATA_DIR (.env) or pass --root_data_dir / --synthetic_data")
    return root


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
    """(train_ds, val_ds) on the port's jax-free readers, for ``--dataset
    sunrgbd|daquar``."""
    from ..data.dataset import DAQUARVQADataset, SUNRGBDVQADataset

    if args.dataset == "daquar":
        return (DAQUARVQADataset(root, args.train_csv, args.subset_percentage),
                DAQUARVQADataset(root, args.val_csv, args.subset_percentage))
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
    p.add_argument("--teacher_weights", type=str, default=None,
                   help="local HF snapshot dir for the 7B teacher")
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


def resolve_attn_impl(args, device: torch.device, cfg, trainable: bool = False) -> str:
    """``--attn_impl`` if given, else the flash kernels on CUDA for a config
    whose head dims they take (the backward's too for a model that trains),
    and the plain path otherwise: on the CPU (as the JAX package picks
    "pallas" on a TPU and "xla" on the CPU) and for the tiny configs."""
    if args.attn_impl:
        return args.attn_impl
    from ..ops.flash_attention import BWD_HEAD_DIMS, KERNEL_HEAD_DIMS

    dims = BWD_HEAD_DIMS if trainable else KERNEL_HEAD_DIMS
    taken = cfg.vision.head_dim in dims and cfg.text.head_dim in dims
    return "flash" if device.type == "cuda" and taken else "xla"


def resolve_ce_impl(device: torch.device, cfg) -> str:
    """The route of the vocabulary losses (``TrainConfig.ce_impl``): the
    fused kernels on CUDA for a student whose width they take, else the
    plain chunked route (on the CPU and for the tiny configs), as the JAX
    CLIs pick "fused" only on one TPU chip at a real config."""
    from ..ops.fused_ce import KERNEL_DIMS

    return "fused" if device.type == "cuda" and cfg.text.hidden_size in KERNEL_DIMS else "chunked"


def init_or_load_params(
    cfg,
    weights_path: Optional[str],
    seed: int,
    *,
    attn_impl: str,
    device: torch.device,
    dtype: torch.dtype,
    trainable: bool = False,
    quant: str = "none",
) -> LlavaOnevision:
    """Build the model on ``device`` in ``dtype``: weights from a local HF
    snapshot, or a seeded random init drawn tensor by tensor in float32 (so
    the 7B teacher never exists as a whole in float32 on the card).
    ``trainable=False`` (serving, the frozen teacher) freezes the weights in
    eval mode; ``True`` gives a model in train mode whose parameters require
    grad.  ``quant`` (``QUANT_MODES``, frozen models only) then quantizes
    the model in place on ``device``, one projection at a time, as the JAX
    CLIs quantize the bf16 tree once after building it."""
    if quant not in QUANT_MODES or (quant != "none" and trainable):
        raise ValueError(f"quant must be one of {QUANT_MODES}, and 'none' for a trainable model; got {quant!r}")
    model = LlavaOnevision(cfg, attn_impl=attn_impl, device=device, dtype=dtype)
    if weights_path:
        from ..models.convert import load_llava_onevision_params

        model.load_state_dict(load_llava_onevision_params(weights_path, cfg))
    else:
        init_weights(model, seed)
    model.requires_grad_(trainable)
    if quant != "none":
        from ..ops.int8 import quantize_model_int8

        quantize_model_int8(model, include_vision=quant == "int8_full")
    return model.train() if trainable else model.eval()
