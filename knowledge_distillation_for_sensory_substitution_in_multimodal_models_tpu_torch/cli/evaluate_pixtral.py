"""Pixtral zero-shot evaluator (port of the JAX package's
``cli/evaluate_pixtral.py``; parity with the reference's
`evaluation/pixtral/evaluate_pixtral.py:105-198,240-330`).

The reference script does not import (it names a nonexistent
``distillation.pixtral.PixtralModule``, `:15`); this is the working rebuild
of what it evidently intends: walk the val/test CSV on the RGB stream,
prompt ``<s>[INST] {q}.Answer in one word.Don't use the word
'based'.\\n[IMG][/INST]``, greedy-generate 32 tokens, extract the answer
(split on '.', last segment, lowercase, numbers to words), and write
``dataset/predictions/results_{gts}_pixtral.csv`` with the columns
Question_Id / Questions / Question_Type / Answers / Model_Answer, then the
incremental summary.

Backends:

* ``--backend student`` (default): the port's 0.5B OneVision student
  (``eval/runner.py::load_student_for_eval``: seed 0, the best checkpoint
  of ``--student_ckpt_dir`` when one is named, which must hold one), on
  ``cuda:0`` unless ``--cpu``; ``--synthetic_data`` / ``--tiny_model``
  take the tiny config;
* ``--backend hf --model_path SNAPSHOT``: the reference's Pixtral-12B
  through ``transformers`` from a local snapshot (``local_files_only``),
  fp16 on ``cuda:0`` unless ``--cpu`` (float32 there).

Unlike the JAX loop, which counts any exception of a row as an error and
goes on (`:135-148`), only reading a row is tolerated (a missing image
counts as an error); a failure of the answer backend (the model, a kernel,
the card) propagates, so that it cannot end as missing rows under exit 0.

The JAX flag set (``common.add_jax_flag_set``): the trainers' eight host
flags are parsed and not read, as in the JAX CLI; ``--distributed`` and a
``--mesh`` over more than one rank are refused (one process).

Offline smoke on the CPU:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.evaluate_pixtral \\
      --synthetic_data --cpu --max_new_tokens 4 --predictions_dir /tmp/preds
"""

from __future__ import annotations

import argparse
import os
import tempfile

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=1, help="reference flag (per-row loop; kept for parity)")
    p.add_argument("--subset_percentage", type=float, default=None)
    p.add_argument("--gts_type", type=str, default="val", choices=["val", "test"])
    p.add_argument("--backend", type=str, default="student", choices=["hf", "student"])
    p.add_argument("--model_path", type=str, default=None, help="local Pixtral snapshot (--backend hf)")
    p.add_argument("--student_ckpt_dir", type=str, default=None)
    p.add_argument("--predictions_dir", type=str, default="dataset/predictions")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--root_data_dir", type=str, default=None)
    common.add_jax_flag_set(p, mesh_note=common.ONE_PROCESS)
    return p


ADDITIONAL_INSTRUCTIONS = ".Answer in one word.Don't use the word 'based'."


def extract_answer(text: str) -> str:
    """Reference extraction (`evaluate_pixtral.py:137-150`): the last
    '.'-separated segment, lowercased, digits to words."""
    from ..utils.numwords import digits_to_words

    final = text.split(".")[-1].strip().lower()
    return digits_to_words(final).strip()


def make_hf_answer_fn(model_path: str, max_new_tokens: int, cpu: bool = False):
    """The reference's generate path on a local Pixtral snapshot
    (`evaluate_pixtral.py:105-136`): fp16 on ``cuda:0``, or float32 on the
    CPU when ``cpu``; without a CUDA device and without ``cpu`` it raises
    (``common.setup_device``)."""
    import torch
    from PIL import Image
    from transformers import AutoProcessor, LlavaForConditionalGeneration

    device = common.setup_device(argparse.Namespace(cpu=cpu))
    processor = AutoProcessor.from_pretrained(model_path, local_files_only=True)
    model = LlavaForConditionalGeneration.from_pretrained(
        model_path, local_files_only=True, torch_dtype=torch.float32 if cpu else torch.float16)
    model = model.to(device).eval()
    pad = (processor.tokenizer.pad_token_id if processor.tokenizer.pad_token_id is not None
           else processor.tokenizer.eos_token_id)

    def answer(image, question):
        prompt = f"<s>[INST]{question}{ADDITIONAL_INSTRUCTIONS}\n[IMG][/INST]"
        inputs = processor(images=Image.fromarray(image), text=prompt, return_tensors="pt").to(model.device)
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens, pad_token_id=pad)
        return processor.decode(out[0], skip_special_tokens=True)

    return answer


def main(argv=None) -> dict:
    """Run the evaluation; returns the rows, the CSV path and the count of
    rows that could not be read."""
    args = build_parser().parse_args(argv)
    common.refuse_mesh(args, "cli/evaluate_pixtral.py")
    common.load_env()

    import pandas as pd

    from ..data.dataset import SUNRGBDVQADataset
    from ..eval.results import update_summary

    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        root = common.ensure_synthetic_dataset(root or tempfile.mkdtemp(prefix="kdss_synth_"))
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir / --synthetic_data")

    if args.backend == "hf":
        if not args.model_path:
            raise SystemExit("--backend hf needs --model_path (local snapshot)")
        answer_fn = make_hf_answer_fn(args.model_path, args.max_new_tokens, cpu=args.cpu)
    else:
        from ..eval import runner

        answer_fn = runner.load_student_for_eval(args.student_ckpt_dir, args.tokenizer_path,
                                                 tiny=common.is_tiny(args), cpu=args.cpu,
                                                 max_new_tokens=args.max_new_tokens)

    ds = SUNRGBDVQADataset(root, f"{args.gts_type}_dataset.csv", args.subset_percentage)
    df = ds.df

    rows = []
    errors = 0
    for i in range(len(ds)):
        try:  # the reference's tolerance (`evaluate_pixtral.py:326-328`), for reading a row only
            question, gt, rgb, _depth, _ = ds[i]
        except Exception:
            errors += 1
            continue
        raw = answer_fn(rgb, question + ADDITIONAL_INSTRUCTIONS)
        rows.append({
            "Question_Id": int(df.iloc[i]["Question_Id"]) if "Question_Id" in df.columns else i,
            "Questions": question,
            "Question_Type": df.iloc[i].get("Question_Type", ""),
            "Answers": gt,
            "Model_Answer": extract_answer(raw),
        })
        if i % 25 == 0:
            print(f"evaluated {i + 1}/{len(ds)}", flush=True)

    os.makedirs(args.predictions_dir, exist_ok=True)
    out_path = os.path.join(args.predictions_dir, f"results_{args.gts_type}_pixtral.csv")
    pd.DataFrame(rows).to_csv(out_path, index=False)
    print(f"Results saved to: {out_path} ({errors} errors)")

    summary = update_summary(args.predictions_dir)
    print("summary:", summary.tail(1).to_dict("records"))
    return dict(rows=rows, path=out_path, errors=errors)


if __name__ == "__main__":
    main()
