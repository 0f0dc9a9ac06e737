"""Single-sample inference demo (port of the JAX package's ``cli/inference.py``):
load a checkpoint (``--student_ckpt_path``, one of the port's train CLIs'),
encode one depth image, generate one answer, print a one-row DataFrame.
``--quant int8`` serves the student with w8a8 decoder-block projections,
``int8_full`` with the SigLIP encoder's too (the tied embedding and head
stay float, as in the JAX CLI).

The JAX flag set (``common.add_jax_flag_set``): the trainers' eight host
flags are parsed and not read, as in the JAX CLI.  ``--mesh`` and
``--distributed`` are parsed, as the JAX CLI parses them and never reads
them; a one-rank ``--mesh`` is accepted, while ``--distributed`` and a
``--mesh`` over more than one rank are refused (each rank would run the
whole model): the evaluator generates under a mesh.

Offline smoke on the CPU:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.inference \\
      --synthetic_data --cpu --max_new_tokens 4
"""

from __future__ import annotations

import argparse
import os
import tempfile

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--row", type=int, default=0, help="dataset row to run")
    p.add_argument("--gts_type", type=str, default="val")
    common.add_serving_flags(p)
    common.add_jax_flag_set(p, mesh_note=common.ONE_PROCESS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.refuse_mesh(args, "cli/inference.py")
    common.load_env()
    device = common.setup_device(args)

    import pandas as pd

    from ..data.collate import OneVisionCollator
    from ..data.dataset import SUNRGBDVQADataset
    from ..eval.decode import GenerateConfig, Generator, eval_batch
    from ..utils.numwords import digits_to_words

    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        root = common.ensure_synthetic_dataset(root or tempfile.mkdtemp(prefix="kdss_synth_"))
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir / --synthetic_data")

    scfg, _ = common.model_configs(args)
    model = common.load_student(args, scfg, device)
    tok = common.make_tokenizer(args, scfg)

    ds = SUNRGBDVQADataset(root, f"{args.gts_type}_dataset.csv", depth_encoding="prewitt_imagenet")
    sample = ds[args.row]
    buckets = (256,) if common.is_tiny(args) else None
    collator = OneVisionCollator(scfg, tok, eval_mode=True, **(dict(buckets=buckets) if buckets else {}))
    batch = collator([sample])
    if args.pixel_data_type == "rgb":
        batch["student_pixel_values"] = batch["teacher_pixel_values"]
    tb = eval_batch(batch, device)

    gen = Generator(scfg, GenerateConfig(max_new_tokens=args.max_new_tokens,
                                         eos_token_id=scfg.eos_token_id))
    out = gen.generate(model, tb)
    seqs = out["sequences"][0].cpu().tolist()
    valid = out["valid"][0].cpu().tolist()
    plen = int(out["prompt_lengths"][0])
    gen_ids = [t for t, v in zip(seqs[plen:], valid[plen:]) if v]
    if gen_ids and gen_ids[-1] == scfg.eos_token_id:
        gen_ids = gen_ids[:-1]
    answer = digits_to_words(tok.decode(gen_ids).strip()).lower()

    print(pd.DataFrame([{
        "Question": sample[0],
        "Ground_Truth": sample[1],
        "Model_Answer": answer,
    }]).to_string(index=False))


if __name__ == "__main__":
    main()
