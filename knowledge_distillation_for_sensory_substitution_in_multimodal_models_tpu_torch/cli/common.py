"""Shared CLI plumbing (port of the JAX package's ``cli/common.py``):
``.env`` loading, the flags this port implements, tiny/real config choice,
the tokenizer, the synthetic SUNRGBD and DAQUAR trees, device set-up, the
attention and loss routes (``resolve_attn_impl``, ``resolve_ce_impl``),
``make_datasets``, ``init_or_load_params``, and the served model of the
inference and evaluator CLIs (``add_serving_flags``, ``load_student``).

Flag sets: the trainers take ``add_device_flags``, ``add_mesh_flags`` and
``add_train_flags``; every other CLI takes the JAX ``add_tpu_flags`` set
through :func:`add_jax_flag_set` (the same three, the trainers' eight host
flags parsed and not read, as the JAX CLIs parse them).

Multi-GPU (the trainers): ``--distributed`` joins the process group that
``torchrun`` describes in the environment (NCCL on CUDA, gloo with
``--cpu``; :func:`init_distributed`), each rank on ``cuda:LOCAL_RANK``;
``--mesh d,f,t`` shapes the ranks into the (data, fsdp, tensor) mesh
(:func:`build_mesh`, as the JAX ``build_mesh``: all ranks on ``tensor``
when the flag is absent).  A one-rank ``--distributed`` run takes the mesh
paths too (FSDP2 over one rank).
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

# --attn_impl: the JAX values ("pallas" is the port's kernels, "pallas_spmd"
# the kernels on each rank's local shard under a mesh, "xla_chunked" the
# query-chunked plain path) and "flash", the port's older name of "pallas".
ATTN_IMPLS = ("xla", "pallas", "pallas_spmd", "xla_chunked", "flash")
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


# the help of a flag that a CLI takes for the JAX flag set and never reads
UNREAD = "parsed for the JAX CLI's flag set; this CLI does not read it"


def add_train_flags(p: argparse.ArgumentParser, unread: bool = False) -> None:
    """The JAX trainers' data, checkpoint and logging flags (the JAX
    defaults).  ``unread``: the CLIs that take them only for the JAX flag
    set (:func:`add_jax_flag_set`); their help says so."""

    def h(text=None):
        return UNREAD if unread else text

    p.add_argument("--checkpoint_dir", type=str, default="checkpoints", help=h())
    p.add_argument("--tensorboard_dir", type=str, default="tensorboard_logs", help=h())
    p.add_argument("--profile_dir", type=str, default=None,
                   help=h("trace train steps 2-4 with torch.profiler into this directory"))
    p.add_argument("--num_workers", type=int, default=4, help=h())
    p.add_argument("--depth_encoding", type=str, default="prewitt",
                   choices=["prewitt", "gray3", "prewitt_imagenet"], help=h())
    p.add_argument("--train_csv", type=str, default="train_dataset.csv", help=h())
    p.add_argument("--val_csv", type=str, default="val_dataset.csv", help=h())
    p.add_argument("--dataset", type=str, default="sunrgbd", choices=["sunrgbd", "daquar"], help=h())


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
                   help="default: the kernels on CUDA (pallas_spmd under a multi-rank mesh), xla on the CPU")
    p.add_argument("--seed", type=int, default=0)


def add_mesh_flags(p: argparse.ArgumentParser, note: str = "") -> None:
    """The multi-GPU flags (the JAX ``--distributed`` and ``--mesh``) of the
    trainers and the evaluator; ``note`` ends both helps."""
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed process group torchrun describes (RANK, WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL on CUDA, gloo with --cpu" + note)
    p.add_argument("--mesh", type=str, default=None,
                   help="data,fsdp,tensor (default: all ranks on tensor); needs --distributed" + note)


def add_jax_flag_set(p: argparse.ArgumentParser, mesh_note: str = "") -> None:
    """The flag set of the JAX ``add_tpu_flags`` for the CLIs other than the
    trainers, with the JAX defaults: :func:`add_device_flags`,
    :func:`add_mesh_flags` (``mesh_note`` ends their help) and the
    trainers' eight host flags (:func:`add_train_flags`), which these CLIs
    parse and do not read, as the JAX CLIs parse them and never read them."""
    add_device_flags(p)
    add_mesh_flags(p, mesh_note)
    add_train_flags(p, unread=True)


# --mesh_note of the CLIs that run one process
ONE_PROCESS = ("; this CLI runs one process: --distributed and a --mesh over more than one rank are refused "
               "(cli/evaluate_onevision.py generates under a mesh)")


def refuse_mesh(args, cli: str) -> None:
    """For a CLI that runs one process on one device: refuse
    ``--distributed`` and a ``--mesh`` over more than one rank (a launch of
    several ranks would run the whole model on every rank), naming the
    evaluator, which generates under a mesh.  A one-rank ``--mesh`` is
    accepted and changes nothing."""
    from ..parallel.mesh import parse_mesh

    if args.distributed or (args.mesh and parse_mesh(args.mesh).num_devices > 1):
        raise SystemExit(f"{cli} runs one process on one device: --distributed and a --mesh over more than one "
                         "rank are refused (each rank would run the whole model); cli/evaluate_onevision.py "
                         "generates under --distributed --mesh")


def add_serving_flags(p: argparse.ArgumentParser, quant_note: str = "") -> None:
    """The flags the inference and evaluator CLIs share, beside
    :func:`add_jax_flag_set`; ``quant_note`` ends ``--quant``'s help."""
    p.add_argument("--student_ckpt_path", type=str, default=None,
                   help="a checkpoint of the port's train CLIs (epoch=NN-val_loss=X.ckpt); its "
                        "weights replace the initial ones (params-only restore)")
    p.add_argument("--pixel_data_type", type=str, default="depth", choices=["depth", "rgb"])
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--root_data_dir", type=str, default=None)
    p.add_argument("--quant", type=str, default="none", choices=QUANT_MODES,
                   help="int8: w8a8 LM decoder-block projections (decode at batch 1 is "
                        "weight-bandwidth-bound, int8 halves the bytes); int8_full: the SigLIP "
                        "projections too (ops/int8.py)" + quant_note)


def load_student(args, cfg, device: torch.device) -> LlavaOnevision:
    """The served model of the inference and evaluator CLIs: built from
    ``--student_weights`` or the seed, then ``--student_ckpt_path``'s
    weights (a params-only restore; a path that names no file is refused),
    then ``--quant`` (after the restore, as the JAX CLIs quantize: the
    checkpoints stay float)."""
    model = init_or_load_params(cfg, args.student_weights, args.seed,
                                attn_impl=resolve_attn_impl(args, device, cfg),
                                device=device, dtype=model_dtype(device))
    path = args.student_ckpt_path
    if path:
        if not os.path.isfile(path):
            raise SystemExit(f"--student_ckpt_path {path}: no such checkpoint file")
        from ..train.checkpoint import CheckpointManager

        CheckpointManager(os.path.dirname(path) or ".").restore_model(path, model, map_location=device)
        print(f"loaded student params from {path}", flush=True)
    if args.quant != "none":
        from ..ops.int8 import quantize_model_int8

        quantize_model_int8(model, include_vision=args.quant == "int8_full")
    return model


def setup_device(args) -> torch.device:
    """``cuda:0`` unless ``--cpu`` (``cuda:LOCAL_RANK`` with
    ``--distributed``).  Without a CUDA device and without ``--cpu`` this
    raises: nothing carries on on the CPU in its place."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --cpu to run on the CPU")
    # Full-f32 references on the card: matmuls are f32 by default, but
    # cuDNN convolutions (the patch embed) default to TF32.  Set both.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    index = int(os.environ.get("LOCAL_RANK", 0)) if getattr(args, "distributed", False) else 0
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_distributed(args) -> None:
    """With ``--distributed``: ``init_process_group`` from the environment
    torchrun sets (NCCL on CUDA, gloo with ``--cpu``), unless a group is
    already up.  Without it, a ``--mesh`` of more than one rank is refused."""
    import torch.distributed as dist

    if not getattr(args, "distributed", False):
        if getattr(args, "mesh", None):
            from ..parallel.mesh import parse_mesh

            if parse_mesh(args.mesh).num_devices > 1:
                raise SystemExit("--mesh over more than one rank needs --distributed (under torchrun)")
        return
    if not dist.is_initialized():
        dist.init_process_group("gloo" if args.cpu else "nccl")


def finish_distributed(args) -> None:
    """Leave the process group :func:`init_distributed` joined."""
    import torch.distributed as dist

    if getattr(args, "distributed", False) and dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(args):
    """The (data, fsdp, tensor) mesh of a ``--distributed`` run (None
    otherwise), as the JAX ``build_mesh``: ``--mesh`` if given, else
    (1, 1, 1) on one rank and ``MeshConfig.for_devices(n)`` on n."""
    if not getattr(args, "distributed", False):
        return None
    import torch.distributed as dist

    from ..parallel import MeshConfig, make_mesh
    from ..parallel.mesh import parse_mesh

    n = dist.get_world_size()
    if args.mesh:
        mc = parse_mesh(args.mesh)
    elif n == 1:
        mc = MeshConfig(1, 1, 1)
    else:
        mc = MeshConfig.for_devices(n)
    return make_mesh(mc, "cpu" if args.cpu else "cuda")


def model_dtype(device: torch.device) -> torch.dtype:
    """The model's (compute) dtype: bf16 on CUDA (as the JAX CLI computes in
    bf16 on the TPU), f32 on the CPU.  Training keeps float32 masters of
    bf16 parameters in the optimizer (``train/optimizer.py``)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def resolve_attn_impl(args, device: torch.device, cfg, trainable: bool = False) -> str:
    """``--attn_impl`` if given, else the flash kernels on CUDA for a config
    whose head dims they take (the backward's too for a model that trains),
    and the plain path otherwise: on the CPU (as the JAX package picks
    "pallas" on a TPU and "xla" on the CPU) and for the tiny configs.
    Under a mesh of more than one rank the kernels are "pallas_spmd" (each
    rank's local batch and heads), as the JAX function picks on TPUs."""
    if args.attn_impl:
        return args.attn_impl
    from ..ops.flash_attention import BWD_HEAD_DIMS, KERNEL_HEAD_DIMS

    dims = BWD_HEAD_DIMS if trainable else KERNEL_HEAD_DIMS
    taken = cfg.vision.head_dim in dims and cfg.text.head_dim in dims
    if device.type != "cuda" or not taken:
        return "xla"
    import torch.distributed as dist

    multi = getattr(args, "distributed", False) and dist.is_initialized() and dist.get_world_size() > 1
    return "pallas_spmd" if multi else "flash"


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
    remat: bool = False,
) -> LlavaOnevision:
    """Build the model on ``device`` in ``dtype``: weights from a local HF
    snapshot, or a seeded random init drawn tensor by tensor in float32 (so
    the 7B teacher never exists as a whole in float32 on the card).
    ``trainable=False`` (serving, the frozen teacher) freezes the weights in
    eval mode; ``True`` gives a model in train mode whose parameters require
    grad.  ``quant`` (``QUANT_MODES``, frozen models only) then quantizes
    the model in place on ``device``, one projection at a time, as the JAX
    CLIs quantize the bf16 tree once after building it.  ``remat``: each
    layer recomputed in the backward (``models/remat.py``, the "full"
    policy), as the JAX CLIs build both models at full width.  On the meta
    device a model without a snapshot is built without weights (a
    shape-only build)."""
    if quant not in QUANT_MODES or (quant != "none" and trainable):
        raise ValueError(f"quant must be one of {QUANT_MODES}, and 'none' for a trainable model; got {quant!r}")
    model = LlavaOnevision(cfg, attn_impl=attn_impl, device=device, dtype=dtype, remat=remat)
    if weights_path:
        from ..models.convert import load_llava_onevision_params

        model.load_state_dict(load_llava_onevision_params(weights_path, cfg))
    elif torch.device(device).type != "meta":
        init_weights(model, seed)
    model.requires_grad_(trainable)
    if quant != "none":
        from ..ops.int8 import quantize_model_int8

        quantize_model_int8(model, include_vision=quant == "int8_full")
    return model.train() if trainable else model.eval()
