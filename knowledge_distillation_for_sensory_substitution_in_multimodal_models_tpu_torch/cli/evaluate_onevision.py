"""Evaluator CLI (port of the JAX package's ``cli/evaluate_onevision.py``;
parity with the reference's ``evaluation/onevisionv3/evaluate_onevision.py``).

Greedy batched generation of one answer per row of a SUNRGBD split, written
to the reference's predictions CSV (columns Question_Id, Questions,
Question_Type, Answers, Model_Answer; file
``results_kd_modeltypeL{pixel_data_type}_{gts_type}_{kd_model_type}{phase}.csv``),
then the incremental summary (``summary/results_summary.csv``).  The JAX
CLI's flags (``common.add_jax_flag_set``; the trainers' eight host flags
are parsed and not read, as in the JAX CLI).  One card (``cuda:0``) unless
``--cpu`` is given.

Sharded generation (JAX ``cli/evaluate_onevision.py:160-170``): under
``torchrun --nproc_per_node N ... --distributed --mesh d,f,t`` (each rank on
``cuda:LOCAL_RANK``; gloo with ``--cpu``) the served model is sharded by
``parallel.shard_params`` after the checkpoint restore and the ``--quant``
swap, and generates under the mesh.  Every rank runs every batch, whole
(the JAX evaluator does not shard the batch either), and the decode loop
runs exactly ``--max_new_tokens`` steps, so every rank makes the same
forward calls; rank 0 writes the CSV and the summary, and every rank
returns the same rows.  ``--distributed`` shards even on one rank (as the
trainers do; the JAX CLI skips a one-device mesh).  An int8 model
(``--quant int8|int8_full``) stays replicated on every rank (see
``--quant``).

* ``--model_id`` naming a 7B model evaluates the 7B config (with
  ``--real_model`` or real data);
* ``--student_ckpt_path`` restores a checkpoint of the port's train CLIs
  (weights only), ``--quant int8|int8_full`` quantizes after it;
* ``--eval_batch_size`` pads a ragged tail batch (repeating its last row)
  and drops the pad rows from the CSV;
* the hash tokenizer's reverse map is seeded with the split's answers, so a
  correct answer id decodes back to its word.

Offline smoke on the CPU:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.evaluate_onevision \\
      --synthetic_data --cpu --max_new_tokens 4 --predictions_dir /tmp/preds
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_id", type=str, default="llava-hf/llava-onevision-qwen2-0.5b-ov-hf")
    p.add_argument("--gts_type", type=str, default="val", choices=["val", "test"])
    p.add_argument("--kd_model_type", type=str, default="double_trouble")
    p.add_argument("--phase_no", type=str, default="3")
    p.add_argument("--subset_percentage", type=float, default=None)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--predictions_dir", type=str, default="dataset/predictions")
    p.add_argument("--eval_depth_quirk", action="store_true", default=True)
    p.add_argument("--no_eval_depth_quirk", dest="eval_depth_quirk", action="store_false")
    p.add_argument("--metric_backend", type=str, default="auto", choices=["auto", "spacy", "hashed"],
                   help="spacy: hard-fail unless spaCy+en_core_web_md is importable (reference-exact "
                        "metrics); hashed: force the offline fallback; auto: spaCy when available "
                        "(eval/metrics.py)")
    p.add_argument("--prompt_style", type=str, default="reference", choices=["reference", "train"],
                   help="reference: the paper's eval prompt; train: the training template's "
                        "assistant header verbatim (data/chat.py)")
    common.add_serving_flags(p, quant_note=QUANT_MESH_NOTE)
    common.add_jax_flag_set(p)
    return p


QUANT_MESH_NOTE = (
    ". Under --distributed an int8 model stays replicated on every rank: torch's parallel styles take "
    "nn.Linear and nn.Embedding only; a row-wise w8a8 split would change each row's activation absmax "
    "unless that max were all-reduced, and would need K12 (which fuses the quantize pass and the scale "
    "epilogue) to emit int32 partial sums, so its tokens would no longer equal one device's by "
    "construction; and one card cannot measure the memory that sharding would save")


def predictions_file(args) -> str:
    """The reference's predictions CSV name."""
    phase = f"phase{args.phase_no}" if args.kd_model_type == "double_trouble" else ""
    return f"results_kd_modeltypeL{args.pixel_data_type}_{args.gts_type}_{args.kd_model_type}{phase}.csv"


def main(argv=None) -> dict:
    """Run the evaluation; returns the rows (with each row's generated
    ``tokens`` and their ``margins``, which the CSV leaves out), the CSV
    path, and the wall split: ``host_s`` (reading rows: image decode and the
    depth encoding; collation: anyres tiles and the prompt) and
    ``generate_s`` (generation, synchronised on the card).  Under
    ``--distributed`` every rank returns the same rows; rank 0 writes."""
    args = build_parser().parse_args(argv)
    common.load_env()
    common.init_distributed(args)
    device = common.setup_device(args)
    mesh = common.build_mesh(args)

    import pandas as pd
    import torch
    from torch.distributed.fsdp import FSDPModule

    from ..data.collate import OneVisionCollator
    from ..data.dataset import SUNRGBDVQADataset
    from ..eval.decode import GenerateConfig, Generator
    from ..eval.metrics import force_backend
    from ..eval.results import update_summary
    from ..parallel import shard_params, use_mesh
    from ..parallel.mesh import is_rank0
    from ..utils.numwords import digits_to_words

    force_backend(args.metric_backend)
    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        # ranks that share a --root_data_dir: rank 0 writes the tree
        shared = root is not None and torch.distributed.is_initialized()
        if not shared or is_rank0():
            root = common.ensure_synthetic_dataset(root or tempfile.mkdtemp(prefix="kdss_synth_"))
        if shared:
            torch.distributed.barrier()
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir / --synthetic_data")

    scfg, tcfg = common.model_configs(args)
    # --model_id selects the architecture: the reference's results_*_7b.csv
    # runs evaluate the 7B model directly
    if "7b" in args.model_id.lower() and not common.is_tiny(args):
        scfg = tcfg
    model = common.load_student(args, scfg, device)
    if mesh is not None:
        # after the restore and the --quant swap, as the JAX CLI shards
        shard_params(model, mesh)
    tok = common.make_tokenizer(args, scfg)

    ds = SUNRGBDVQADataset(root, f"{args.gts_type}_dataset.csv", args.subset_percentage,
                           depth_encoding="prewitt_imagenet" if args.eval_depth_quirk else "prewitt")
    buckets = (256,) if common.is_tiny(args) else None
    collator = OneVisionCollator(scfg, tok, eval_mode=True, prompt_style=args.prompt_style,
                                 **(dict(buckets=buckets) if buckets else {}))
    gen = Generator(scfg, GenerateConfig(max_new_tokens=args.max_new_tokens, eos_token_id=scfg.eos_token_id))

    # The hash tokenizer decodes only ids of words it has encoded: seed its
    # reverse map with the answers, so a correct answer id decodes to its
    # word (a no-op for HF tokenizers, and for wrong answers).
    if hasattr(tok, "_rev"):
        answers = ds.df["Answers"] if "Answers" in ds.df.columns else ds.df.iloc[:, 2]
        for a in answers.astype(str):
            tok.encode(a)
            tok.encode(a.lower())

    rows, df, bs = [], ds.df, args.eval_batch_size
    host_s = generate_s = 0.0
    for start in range(0, len(ds), bs):
        t0 = time.perf_counter()
        idxs = list(range(start, min(start + bs, len(ds))))
        samples = [ds[i] for i in idxs]
        # pad a ragged tail batch to the batch size (repeat its last row),
        # so every batch has one shape; the pad rows are dropped below
        n_real = len(samples)
        samples = samples + [samples[-1]] * (bs - n_real)
        batch = collator(samples)
        if args.pixel_data_type == "rgb":
            batch["student_pixel_values"] = batch["teacher_pixel_values"]
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
              if not k.startswith("teacher_") and k != "question_id"}
        t1 = time.perf_counter()
        with use_mesh(mesh):
            out = gen.generate(model, tb)
        if isinstance(model, FSDPModule):
            # FSDP2 keeps the root's own parameters gathered after a forward
            # (for a backward); free them between batches
            model.reshard()
        seqs, valid = out["sequences"][:n_real].cpu(), out["valid"][:n_real].cpu()
        plens = out["prompt_lengths"][:n_real].cpu()
        tokens, margins = out["tokens"][:n_real].cpu(), out["margins"][:n_real].float().cpu()
        t2 = time.perf_counter()
        host_s, generate_s = host_s + (t1 - t0), generate_s + (t2 - t1)
        for j, i in enumerate(idxs):
            p = int(plens[j])
            gen_ids = [int(t) for t, ok in zip(seqs[j, p:], valid[j, p:]) if ok]
            if gen_ids and gen_ids[-1] == scfg.eos_token_id:
                gen_ids = gen_ids[:-1]
            answer = digits_to_words(tok.decode(gen_ids).strip()).lower().strip()
            rows.append({
                "Question_Id": int(df.iloc[i, 0]) if "Question_Id" in df.columns else i,
                "Questions": samples[j][0],
                "Question_Type": df.iloc[i].get("Question_Type", ""),
                "Answers": samples[j][1],
                "Model_Answer": answer,
                "tokens": tokens[j].tolist(),
                "margins": margins[j].tolist(),
            })
        if start % (10 * bs) == 0 and is_rank0():
            print(f"evaluated {start + len(idxs)}/{len(ds)}", flush=True)

    out_path = os.path.join(args.predictions_dir, predictions_file(args))
    if is_rank0():
        os.makedirs(args.predictions_dir, exist_ok=True)
        pd.DataFrame(rows).drop(columns=["tokens", "margins"]).to_csv(out_path, index=False)
        print("Results saved to:", out_path)
        summary = update_summary(args.predictions_dir)
        print("summary:", summary.tail(1).to_dict("records"))
    common.finish_distributed(args)
    return dict(rows=rows, path=out_path, host_s=host_s, generate_s=generate_s)


if __name__ == "__main__":
    main()
