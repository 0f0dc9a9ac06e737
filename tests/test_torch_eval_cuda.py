"""The evaluator CLI on the card at B=4 against B=1, the 0.5B student at
full width and depth (seeded random weights, bf16), on a synthetic SUNRGBD
split whose frames cycle through the four sensor sizes (kv2 730x530, kv1
561x427, realsense 681x531, xtion 640x480): prompts in one batch differ in
length, so K3's kv mask masks.

* the rows of B=4 are those of B=1 (same Question_Ids, no pad row);
* each row's generated tokens are equal, or, from the first step where
  they differ, B=1's top-2 margin there is within 2 x 2e-2 x max(1, max
  |logit|) of that row's B=1 prefill next-token logits (two logits each off
  by up to the logit bound can swap);
* each row's prefill next-token logits at B=4 against B=1: max abs error
  <= 2e-2 x max(1, max |logit|), relative Frobenius error <= 1e-2.

Needs a CUDA device; skips without one.  Run on the card:
    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py"""

import types

import numpy as np
import pandas as pd
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    evaluate_onevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    llava_onevision_0_5b,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.collate import (
    OneVisionCollator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
    SUNRGBDVQADataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.decode import (
    GenerateConfig,
    Generator,
)

pytestmark = pytest.mark.cuda
SIZES = ((530, 730), (427, 561), (531, 681), (480, 640))
ROWS, BS, N_NEW = 7, 4, 8
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _tree(root):
    from PIL import Image

    common.ensure_synthetic_dataset(str(root), n=ROWS)
    rng = np.random.default_rng(4)
    for i in range(ROWS):
        h, w = SIZES[i % len(SIZES)]
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)).save(
            root / "SUNRGBD" / "img" / f"rgb_{i}.png")
        Image.fromarray(rng.integers(0, 65535, size=(h, w)).astype(np.uint16)).save(
            root / "SUNRGBD" / "img" / f"d_{i}.png")
    return str(root)


def _next_logits(cfg, root, bs, dev):
    model = common.init_or_load_params(cfg, None, 0, attn_impl="flash", device=dev, dtype=torch.bfloat16)
    ds = SUNRGBDVQADataset(root, "val_dataset.csv", depth_encoding="prewitt_imagenet")
    collator = OneVisionCollator(cfg, common.make_tokenizer(types.SimpleNamespace(tokenizer_path=None), cfg),
                                 eval_mode=True)
    gen = Generator(cfg, GenerateConfig(max_new_tokens=N_NEW, eos_token_id=cfg.eos_token_id))
    rows = []
    for start in range(0, ROWS, bs):
        n = min(bs, ROWS - start)
        samples = [ds[i] for i in range(start, start + n)]
        batch = collator(samples + [samples[-1]] * (bs - n))
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
              if not k.startswith("teacher_") and k != "question_id"}
        with torch.no_grad():
            logits, _, lengths = gen.prefill(model, tb)
        rows += [logits[j, int(lengths[j]) - 1].float() for j in range(n)]
    return rows


def test_batched_evaluation_equals_bs1(dev, tmp_path):
    root = _tree(tmp_path / "data")
    outs = {bs: evaluate_onevision.main(["--root_data_dir", root, "--predictions_dir", str(tmp_path / f"p{bs}"),
                                         "--max_new_tokens", str(N_NEW), "--eval_batch_size", str(bs),
                                         "--metric_backend", "hashed"]) for bs in (1, BS)}
    a, b = pd.read_csv(outs[BS]["path"]), pd.read_csv(outs[1]["path"])
    assert len(a) == ROWS and list(a["Question_Id"]) == list(b["Question_Id"])
    cfg = llava_onevision_0_5b()
    for i, (x, y) in enumerate(zip(_next_logits(cfg, root, BS, dev), _next_logits(cfg, root, 1, dev))):
        tol = TOL * max(1.0, y.abs().max().item())
        diff = x - y
        assert diff.abs().max().item() <= tol and (diff.norm() / y.norm()).item() <= 1e-2, i
        ta, tb = outs[BS]["rows"][i]["tokens"], outs[1]["rows"][i]["tokens"]
        if ta != tb:
            t = next(j for j, (p, q) in enumerate(zip(ta, tb)) if p != q)
            assert outs[1]["rows"][i]["margins"][t] <= 2 * tol, (i, t)
