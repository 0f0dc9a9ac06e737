"""Baseline fine-tune CLI (port of the JAX package's ``cli/train.py``, parity
with the reference's `distillation/baseline_depth/train.py` and
`baseline_rgb05b/train.py`): the 0.5B student alone, masked CE, the pixel
stream selected by ``--pixel_stream {depth,rgb}``, the SUNRGBD or
(``--dataset daquar``) the DAQUAR layout.  The CE route and the attention
route are chosen from the config (``common.resolve_ce_impl``,
``common.resolve_attn_impl``): the kernels on CUDA at the real widths, the
plain paths on the CPU and for the tiny config.

Offline smoke on the CPU (tiny config, synthetic SUNRGBD tree):
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.train \\
      --synthetic_data --cpu --accumulate_grad_batches 1
"""

from __future__ import annotations

import argparse
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_reference_flags(p, accum_default=32)
    common.add_device_flags(p)
    common.add_train_flags(p)
    p.add_argument("--pixel_stream", type=str, default="depth", choices=["depth", "rgb"])
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--root_data_dir", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.load_env()
    device = common.setup_device(args)

    from ..configs import TrainConfig
    from ..data.collate import OneVisionCollator
    from ..data.loader import OneVisionLoader
    from ..train import KDModels, TrainState, make_optimizer
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import load_checkpoint_state, run_training, to_device

    train_ds, val_ds = common.make_datasets(args, common.data_root(args))

    scfg, _ = common.model_configs(args)
    tok = common.make_tokenizer(args, scfg)
    buckets = (256,) if common.is_tiny(args) else None
    collator_kw = dict(buckets=buckets) if buckets else {}

    class StreamCollator(OneVisionCollator):
        """Route the chosen pixel stream into the student_* keys (the
        reference's baseline modules differ only in this)."""

        def __call__(self, samples):
            batch = super().__call__(samples)
            if args.pixel_stream == "rgb":
                batch["student_pixel_values"] = batch["teacher_pixel_values"]
            for k in ("teacher_input_ids", "teacher_attention_mask", "teacher_pixel_values"):
                batch.pop(k)
            return batch

    train_loader = OneVisionLoader(
        train_ds, StreamCollator(scfg, tok, **collator_kw),
        batch_size=args.batch_size, accum=args.accumulate_grad_batches,
        shuffle=True, seed=args.seed, num_workers=args.num_workers, drop_ragged=False,
    )
    val_loader = OneVisionLoader(
        val_ds, StreamCollator(scfg, tok, **collator_kw),
        batch_size=args.batch_size, accum=1, shuffle=False,
        num_workers=args.num_workers, drop_ragged=False,
    )

    model = common.init_or_load_params(
        scfg, args.student_weights, args.seed,
        attn_impl=common.resolve_attn_impl(args, device, scfg, trainable=True),
        device=device, dtype=common.model_dtype(device), trainable=True,
    )
    cfg = TrainConfig(
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        subset_percentage=args.subset_percentage,
        load_checkpoint=args.load_checkpoint, augmentation=args.augmentation,
        accumulate_grad_batches=args.accumulate_grad_batches,
        learning_rate=args.learning_rate, kd_mode="baseline",
        pixel_stream=args.pixel_stream, cosine_t_max=0,
        loss_chunk_size=32 if common.is_tiny(args) else 256,
        ce_impl=common.resolve_ce_impl(device, scfg),
    )
    state = TrainState(model, make_optimizer(model, cfg.learning_rate))

    run_name = f"baseline_{args.pixel_stream}"
    ckpt_dir = os.path.join(args.checkpoint_dir, run_name)
    if args.load_checkpoint:
        restored, path = CheckpointManager(ckpt_dir).restore_best(map_location=device)
        if restored is not None:
            state = load_checkpoint_state(state, restored)
            print(f"resumed from {path} at step {state.step}", flush=True)

    run_training(
        KDModels(model, None), cfg, state, None, train_loader, val_loader,
        put=lambda b: to_device(b, device), ckpt_dir=ckpt_dir,
        tb_logdir=args.tensorboard_dir, run_name=run_name,
    )
    print("training complete")


if __name__ == "__main__":
    main()
