"""Dataset-creation CLI (port of the JAX package's ``cli/create_dataset.py``):
one CLI replacing the reference's eight per-type scripts
(`dataset/dataset_creation/{object_identification,count_questions,
Yes_No_Questions,ProximityQuestion_new,direction_questions,color_questions,
merge_all_csv_by_split}.py`).

For each split it walks the annotation path lists, runs every generator
with the reference's try/except-continue error tolerance
(`object_identification.py:268-271`), applies the floor<=500 / wall<=450
caps (`:242-252`), writes per-type CSVs, then merges/cleans/balances into
the final ``{train,val,test}_dataset.csv`` consumed by the data layer.

Color questions are model-in-the-loop in the reference (BLIP per image,
`color_questions.py:151-181`); ``--color_backend`` selects the offline
heuristic (region dominant-color), a local BLIP snapshot, or the student
(``--student_checkpoint``, answered by ``eval/runner.py``'s
``StudentAnswerer``: flash attention on the card).

The JAX CLI's flags, defaults and outputs, with two differences:

* ``--cpu`` runs the student backend on the CPU.  The JAX CLI picks its
  platform from ``JAX_PLATFORMS``; the port's entry points run on the card
  unless asked, and the student backend without ``--cpu`` and without a
  CUDA device raises.
* An exception raised inside the color backend (the model, a kernel, the
  card) propagates and fails the CLI.  The JAX CLI's per-item
  ``except Exception: errors += 1`` also swallows those, so a backend that
  cannot run would show only as missing Color rows.  The reference's
  tolerance stays for everything else in the per-item loop: annotation
  faults, missing polygons, generator errors.

Offline smoke on the CPU (a SUNRGBD toolbox tree under ROOT):
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.create_dataset \\
      --root_data_dir ROOT --splits validation --no_spellcheck
"""

from __future__ import annotations

import argparse
import json
import os
import random

import pandas as pd

from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_data_dir", type=str, default=None,
                   help="dir containing SUNRGBD/ + splits_output_paths/")
    p.add_argument("--splits", nargs="+",
                   default=["train", "validation", "test"])
    p.add_argument("--combined_words_csv", type=str, default=None)
    p.add_argument("--color_backend", type=str, default="heuristic",
                   choices=["heuristic", "blip", "student", "none"],
                   help="color-question VQA backend: 'heuristic' "
                        "(region dominant-color, always available offline), "
                        "'blip' (reference parity, needs --color_model_path), "
                        "'student' (the OneVision student via "
                        "--student_checkpoint), 'none' (skip color CSV)")
    p.add_argument("--color_model_path", type=str, default=None,
                   help="local BLIP-VQA snapshot (--color_backend blip)")
    p.add_argument("--student_checkpoint", type=str, default=None,
                   help="student ckpt dir (--color_backend student)")
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="processor/tokenizer path for the student backend")
    p.add_argument("--toolbox_dir", type=str, default=None,
                   help="run .mat extraction first (SUNRGBDtoolbox dir)")
    p.add_argument("--no_spellcheck", action="store_true",
                   help="skip the (gated) spell-correction stage")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_items", type=int, default=None,
                   help="cap items per split (smoke runs)")
    p.add_argument("--cpu", action="store_true",
                   help="run the student backend on the CPU (default: cuda:0)")
    return p


SPLIT_CSV_NAME = {"train": "train_dataset.csv", "validation": "val_dataset.csv",
                  "test": "test_dataset.csv"}


class ColorBackendError(RuntimeError):
    """A failure inside the color backend; it fails the CLI."""


def _propagating(vqa_fn):
    """``vqa_fn`` whose exceptions come out as ``ColorBackendError``, which
    the per-item loop does not count as a tolerated error."""

    def vqa(image, question, crop=None):
        try:
            return vqa_fn(image, question, crop=crop)
        except Exception as e:
            raise ColorBackendError(f"color backend failed on {question!r}: {e!r}") from e

    return vqa


def make_color_vqa(args):
    """Resolve the color-question backend (data/creation/color_backend.py)."""
    import numpy as np

    from ..data.creation import color_backend as cb
    from ..eval import runner

    if args.color_backend == "none":
        return None
    if args.color_backend == "blip":
        if not args.color_model_path:
            raise SystemExit("--color_backend blip needs --color_model_path")
        return cb.make_blip_color_vqa(args.color_model_path)
    if args.color_backend == "student":
        # cb.make_student_color_vqa with the device choice: it calls the
        # runner with the defaults, which run on the card
        answer_fn = runner.load_student_for_eval(args.student_checkpoint, args.tokenizer_path, cpu=args.cpu)
        return lambda image, question, crop=None: answer_fn(np.asarray(image), question)
    return cb.heuristic_color_vqa


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.load_env()
    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir")

    from ..data.creation.extract import extract_sunrgbd_lists, split_lists
    from ..data.creation.merge import process_split
    from ..data.creation.postprocess import clean_and_dedupe, load_combined_words
    from ..data.creation.questions import (
        color_row,
        count_row,
        direction_row,
        object_identification_row,
        proximity_rows,
        yes_no_rows,
    )

    if args.toolbox_dir:
        lists = extract_sunrgbd_lists(args.toolbox_dir, root)
        split_lists(args.toolbox_dir, lists, root)
        print("toolbox extraction complete")

    combined = load_combined_words(args.combined_words_csv)
    spell = not args.no_spellcheck
    vqa_fn = make_color_vqa(args)
    if vqa_fn is not None:
        vqa_fn = _propagating(vqa_fn)
    rng = random.Random(args.seed)

    def read_paths(split, name):
        p = os.path.join(root, "splits_output_paths", split, name)
        with open(p) as f:
            return [l.strip() for l in f if l.strip()]

    for split in args.splits:
        rgb_paths = read_paths(split, "all_rgb.txt")
        depth_paths = read_paths(split, "all_depth.txt")
        ann_paths = read_paths(split, "annotations.txt")
        if args.max_items:
            rgb_paths = rgb_paths[: args.max_items]
            depth_paths = depth_paths[: args.max_items]
            ann_paths = ann_paths[: args.max_items]

        # running unique-items list for yes/no negatives
        unique_items = set()
        per_type = {t: [] for t in (
            "Object Identification", "Count", "Yes/No", "Proximity",
            "Direction", "Color",
        )}
        floor_count = wall_count = errors = 0
        data_counter = 1

        for rgb_p, depth_p, ann_p in zip(rgb_paths, depth_paths, ann_paths):
            try:
                with open(os.path.join(root, ann_p)) as f:
                    annotation = json.load(f)

                def add(row):
                    if row is None:
                        return
                    rows = row if isinstance(row, list) else [row]
                    for r in rows:
                        r.update({
                            "IDs": data_counter,
                            "Image_Path": rgb_p,
                            "Depth_Path": depth_p,
                        })
                        per_type[r["Question_Type"]].append(r)

                oi = object_identification_row(annotation, combined, spell)
                if oi is not None:
                    # floor/wall caps (`object_identification.py:242-252`)
                    ans = oi["Answers"]
                    if ans == "floor":
                        if floor_count < 500:
                            add(oi)
                            floor_count += 1
                    elif ans == "wall":
                        if wall_count < 450:
                            add(oi)
                            wall_count += 1
                    else:
                        add(oi)
                    unique_items.add(ans)

                add(count_row(annotation, combined, spell))
                add(yes_no_rows(
                    annotation, clean_and_dedupe(unique_items) or ["object"],
                    rng, combined, spell,
                ))
                add(proximity_rows(annotation, combined, spell))
                add(direction_row(annotation, combined, spell))
                if vqa_fn is not None:
                    import numpy as np
                    from PIL import Image

                    img = np.array(
                        Image.open(os.path.join(root, rgb_p)).convert("RGB")
                    )
                    add(color_row(annotation, img, vqa_fn, combined, spell))
            except ColorBackendError:
                raise
            except Exception:
                errors += 1
                continue
            data_counter += 1

        out_dir = os.path.join(root, "SUNRGBD", "csv_data",
                               "individual_datasets", split)
        os.makedirs(out_dir, exist_ok=True)
        dfs = []
        for qtype, rows in per_type.items():
            if not rows:
                continue
            df = pd.DataFrame(rows)[
                ["IDs", "Questions", "Answers", "Image_Path", "Depth_Path",
                 "Question_Type"]
            ]
            fname = qtype.lower().replace("/", "_").replace(" ", "_") + ".csv"
            df.to_csv(os.path.join(out_dir, fname), index=False)
            dfs.append(df)
        print(f"{split}: {sum(len(d) for d in dfs)} rows, {errors} errors")

        if dfs:
            final = process_split(dfs, split)
            final_dir = os.path.join(root, "SUNRGBD", "csv_data")
            os.makedirs(final_dir, exist_ok=True)
            final.to_csv(
                os.path.join(final_dir, SPLIT_CSV_NAME.get(split, f"{split}.csv")),
                index=False,
            )
            print(f"{split}: final {len(final)} rows")


if __name__ == "__main__":
    main()
