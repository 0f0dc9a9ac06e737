"""Online KD trainer CLI (port of the JAX package's ``cli/train_online_kd.py``,
flag parity with the reference's per-config ``train_online_kd.py`` scripts).

``--kd_mode {logit_based,feature_based,double_trouble}`` and ``--phase
{1,2,3}``: the 0.5B student learns from the frozen LLaVA-OneVision-7B teacher
(bf16, built with ``seed + 1``; ``--teacher_quant int8`` then quantizes its
decoder-block projections to w8a8 on the device, ``int8_full`` its SigLIP
encoder's too, its head staying bf16), the student on the depth stream and
the teacher on the RGB stream.  Every mode runs: ``double_trouble`` phase 1
(the default: temperature KL + NT-Xent, the language model frozen), phase 2
(LoCa + CE, the vision tower frozen) and phase 3, ``logit_based`` (LoCa +
CE) and ``feature_based`` (KL + CE + NT-Xent); ``--loca_faithful_indexing``
takes the LoCa term with the reference's full-tensor column writes.  A
fresh double_trouble phase N > 1 run starts from phase N - 1's best
checkpoint (the reference's phase hand-off); ``--load_checkpoint`` resumes
this phase's own best.  Checkpoints go to
``<checkpoint_dir>/kd_{mode}_phase{phase}``.  ``--dataset daquar`` reads the
DAQUAR layout (with ``--synthetic_data``, a synthetic DAQUAR tree).

The routes are chosen from the configs before anything runs: the fused
vocabulary kernels on CUDA for the 896-wide student, the plain chunked
route otherwise (``common.resolve_ce_impl``); the flash kernels for the
head dims they take (``common.resolve_attn_impl``), per model.

Offline smoke on the CPU (tiny configs, synthetic SUNRGBD tree), the
three-phase chain:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.train_online_kd \\
      --synthetic_data --cpu --accumulate_grad_batches 1 --phase 1   # then --phase 2, --phase 3
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_reference_flags(p, accum_default=64)
    common.add_device_flags(p)
    common.add_train_flags(p)
    p.add_argument("--kd_mode", type=str, default="double_trouble",
                   choices=["logit_based", "feature_based", "double_trouble"])
    p.add_argument("--phase", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--root_data_dir", type=str, default=None,
                   help="overrides ROOT_DATA_DIR from .env")
    p.add_argument("--teacher_quant", type=str, default="none", choices=common.QUANT_MODES,
                   help="int8: w8a8 teacher LM projections; int8_full: its SigLIP projections too")
    p.add_argument("--loca_faithful_indexing", action="store_true",
                   help="replicate the reference's full-tensor LoCa fancy indexing instead of "
                        "the paper-correct per-position calibration")
    p.add_argument("--mask_prompt_labels", action="store_true",
                   help="supervise only the assistant-answer tokens")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.load_env()
    device = common.setup_device(args)

    from ..configs import TrainConfig, kd_loss_config_for
    from ..data.collate import OneVisionCollator
    from ..data.loader import OneVisionLoader
    from ..train import KDModels, TrainState, make_optimizer
    from ..train.checkpoint import CheckpointManager, find_best_checkpoint
    from ..train.loop import load_checkpoint_state, run_training, to_device

    train_ds, val_ds = common.make_datasets(args, common.data_root(args))

    scfg, tcfg = common.model_configs(args)
    tok = common.make_tokenizer(args, scfg)
    collator_kw = dict(buckets=(256,)) if common.is_tiny(args) else {}
    if args.mask_prompt_labels:
        collator_kw["mask_prompt_labels"] = True
    train_loader = OneVisionLoader(
        train_ds, OneVisionCollator(scfg, tok, **collator_kw),
        batch_size=args.batch_size, accum=args.accumulate_grad_batches,
        shuffle=True, seed=args.seed, num_workers=args.num_workers, drop_ragged=False,
    )
    val_loader = OneVisionLoader(
        val_ds, OneVisionCollator(scfg, tok, **collator_kw),
        batch_size=args.batch_size, accum=1, shuffle=False,
        num_workers=args.num_workers, drop_ragged=False,
    )

    dtype = common.model_dtype(device)
    student = common.init_or_load_params(scfg, args.student_weights, args.seed,
                                         attn_impl=common.resolve_attn_impl(args, device, scfg, True),
                                         device=device, dtype=dtype, trainable=True)
    teacher = common.init_or_load_params(tcfg, args.teacher_weights, args.seed + 1,
                                         attn_impl=common.resolve_attn_impl(args, device, tcfg),
                                         device=device, dtype=dtype, quant=args.teacher_quant)
    loss_cfg = kd_loss_config_for(args.kd_mode)
    if args.loca_faithful_indexing:
        loss_cfg = dataclasses.replace(loss_cfg, loca_faithful_indexing=True)
    cfg = TrainConfig(
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        subset_percentage=args.subset_percentage,
        load_checkpoint=args.load_checkpoint, augmentation=args.augmentation,
        accumulate_grad_batches=args.accumulate_grad_batches,
        learning_rate=args.learning_rate, kd_mode=args.kd_mode, phase=args.phase, loss=loss_cfg,
        loss_chunk_size=32 if common.is_tiny(args) else 256,
        ce_impl=common.resolve_ce_impl(device, scfg),
    )
    state = TrainState(student, make_optimizer(
        student, cfg.learning_rate, cosine_t_max=cfg.cosine_t_max,
        steps_per_epoch=max(len(train_loader), 1), kd_mode=cfg.kd_mode, phase=cfg.phase))

    ckpt_dir = os.path.join(args.checkpoint_dir, f"kd_{args.kd_mode}_phase{args.phase}")
    if args.kd_mode == "double_trouble" and args.phase > 1 and not args.load_checkpoint:
        prev_dir = os.path.join(args.checkpoint_dir, f"kd_{args.kd_mode}_phase{args.phase - 1}")
        prev = find_best_checkpoint(prev_dir)
        if prev is not None:
            state = CheckpointManager(prev_dir).restore_params(prev, state, map_location=device)
            print(f"phase hand-off: initialized from {prev}", flush=True)
    if args.load_checkpoint:
        restored, path = CheckpointManager(ckpt_dir).restore_best(map_location=device)
        if restored is not None:
            state = load_checkpoint_state(state, restored)
            print(f"resumed from {path} at step {state.step}", flush=True)

    run_name = (
        f"kd_{args.kd_mode}_phase{args.phase}_batch{args.batch_size}"
        f"_epochs{args.max_epochs}_grad_accum{args.accumulate_grad_batches}"
        f"_{'aug' if args.augmentation else 'noaug'}"
    )
    run_training(
        KDModels(student, teacher), cfg, state, None, train_loader, val_loader,
        put=lambda b: to_device(b, device), ckpt_dir=ckpt_dir,
        tb_logdir=args.tensorboard_dir, run_name=run_name,
    )
    print("training complete")


if __name__ == "__main__":
    main()
