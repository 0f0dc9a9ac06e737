"""External-model depth evaluation (port of the JAX package's
``cli/openai_eval_depth.py``; the reference's
`further_scripts/OpenAI_Eval/openai_eval_depth.py:38-186`): send each
question twice to a hosted multimodal model, once with the raw 1-channel
depth render and once with the 3-channel Prewitt encoding, and write the
two results CSVs (``results_openai_depth{1d,3d}_{gts}.csv``).

Gated: it needs the ``openai`` package and ``OPENAI_API_KEY``, and fails
fast with the JAX CLI's messages otherwise.  The image preparation
(``depth_images_for_eval``, both encodings, over the port's
``data/depth.py``) is local.  It touches no model and no card: the JAX
flag set (``common.add_jax_flag_set``) is parsed and not read, device and
mesh flags included, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import base64
import io
import os

import numpy as np

from . import common


def depth_images_for_eval(depth_raw: np.ndarray):
    """(raw 1ch as 8-bit grayscale PNG bytes, Prewitt 3ch PNG bytes)."""
    from PIL import Image

    from ..data.depth import depth_to_3ch_numpy

    d = depth_raw.astype(np.float32)
    dmin, dmax = d.min(), d.max()
    if dmax == dmin:
        dmax = dmin + 1e-6
    gray = (255 * (d - dmin) / (dmax - dmin)).astype(np.uint8)

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    return png(gray), png(depth_to_3ch_numpy(depth_raw))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--gts_type", type=str, default="val")
    p.add_argument("--model", type=str, default="gpt-4o")
    p.add_argument("--root_data_dir", type=str, default=None)
    p.add_argument("--max_items", type=int, default=None)
    p.add_argument("--predictions_dir", type=str, default="dataset/predictions")
    common.add_jax_flag_set(p, mesh_note="; " + common.UNREAD)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.load_env()
    try:
        import openai
    except ImportError:
        raise SystemExit(
            "openai package not installed (offline build environment); "
            "install it and set OPENAI_API_KEY to run this evaluation"
        )
    if not os.environ.get("OPENAI_API_KEY"):
        raise SystemExit("OPENAI_API_KEY not set")

    import pandas as pd
    from PIL import Image

    from ..data.dataset import SUNRGBDVQADataset

    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    ds = SUNRGBDVQADataset(root, f"{args.gts_type}_dataset.csv")
    client = openai.OpenAI()

    def query(png_bytes: bytes, question: str) -> str:
        b64 = base64.b64encode(png_bytes).decode()
        resp = client.chat.completions.create(
            model=args.model,
            messages=[{
                "role": "user",
                "content": [
                    {"type": "text", "text": question + " Answer in one word if possible."},
                    {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}},
                ],
            }],
            max_tokens=32,
        )
        return resp.choices[0].message.content.strip().lower()

    rows_1d, rows_3d = [], []
    n = min(len(ds), args.max_items or len(ds))
    for i in range(n):
        question, answer, _, _, _ = ds[i]
        _, depth_path = ds.image_paths(i)
        depth_raw = np.array(Image.open(depth_path))
        png_1d, png_3d = depth_images_for_eval(depth_raw)
        rows_1d.append({"Questions": question, "Answers": answer, "Model_Answer": query(png_1d, question)})
        rows_3d.append({"Questions": question, "Answers": answer, "Model_Answer": query(png_3d, question)})

    os.makedirs(args.predictions_dir, exist_ok=True)
    pd.DataFrame(rows_1d).to_csv(
        os.path.join(args.predictions_dir, f"results_openai_depth1d_{args.gts_type}.csv"), index=False)
    pd.DataFrame(rows_3d).to_csv(
        os.path.join(args.predictions_dir, f"results_openai_depth3d_{args.gts_type}.csv"), index=False)
    print(f"wrote {n} x2 answers")


if __name__ == "__main__":
    main()
