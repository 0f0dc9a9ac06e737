"""Convert a local HF LLaVA-OneVision snapshot to one checkpoint file of the
port (port of the JAX package's ``cli/convert_weights.py``, which writes an
Orbax params checkpoint).  A one-time import: afterwards the CLIs restore
the file directly (``--student_ckpt_path``, ``CheckpointManager.restore_model``;
``eval/runner.py::load_student_for_eval`` finds it in its directory), which
is much faster than re-running the layout conversion.

The file is one ``torch.save`` of ``{"params": state_dict}`` in ``--dtype``.
Name it ``*.ckpt`` for ``load_student_for_eval``'s directory scan.

Usage:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.convert_weights \\
      --hf_snapshot /path/to/llava-0.5b --model_size 0.5b --output checkpoints/student/converted.ckpt
"""

from __future__ import annotations

import argparse
import os

from ..configs import llava_onevision_0_5b, llava_onevision_7b

# --model_size -> its config
CONFIGS = {"0.5b": llava_onevision_0_5b, "7b": llava_onevision_7b}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hf_snapshot", type=str, required=True,
                   help="local dir with *.safetensors shards")
    p.add_argument("--model_size", type=str, default="0.5b",
                   choices=["0.5b", "7b"])
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..models.convert import load_llava_onevision_params

    cfg = CONFIGS[args.model_size]()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = {k: v.to(dtype) for k, v in load_llava_onevision_params(args.hf_snapshot, cfg).items()}

    out = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"params": params}, out)
    n = sum(v.numel() for v in params.values())
    print(f"converted {n/1e9:.3f}B params -> {out}")


if __name__ == "__main__":
    main()
