"""One-question answerer over the port's ``Generator`` (port of the JAX
package's ``eval/runner.py``).

Factors the per-row answer path of the evaluator
(`evaluation/onevisionv3/evaluate_onevision.py:160-210`: prompt build,
generate, the generated ids after the prompt, numbers to words) into one
object, so that the dataset-creation color backend
(``data/creation/color_backend.py::make_student_color_vqa``) can ask the
student a question about one image.

``load_student_for_eval`` builds the student as the JAX function does, with
two differences:

* the device is ``cuda:0`` unless ``cpu`` is given, and without a CUDA
  device it raises (``cli/common.py::setup_device``): nothing carries on on
  the CPU in its place;
* a named checkpoint directory that holds no checkpoint is refused, as the
  CLIs refuse a ``--student_ckpt_path`` that names no file.  The JAX
  function keeps the random weights there.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


class StudentAnswerer:
    """``answer(rgb_image, question) -> str`` with the port's KV-cache
    greedy ``Generator``.

    ``image`` is an HxWx3 uint8 RGB array.  It goes into both streams of the
    collator's sample, ``(question, "", image, image, 0)``, as in the JAX
    answerer: dataset-creation color questions are asked on RGB, matching
    the reference's BLIP call on the raw image (`color_questions.py:154-181`).
    """

    def __init__(self, model, cfg, tokenizer, *, max_new_tokens: int = 32, buckets=None,
                 device: Optional[torch.device] = None):
        from ..data.collate import OneVisionCollator
        from .decode import GenerateConfig, Generator

        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.device = model.device if device is None else device
        self.collator = OneVisionCollator(cfg, tokenizer, eval_mode=True,
                                          **(dict(buckets=buckets) if buckets else {}))
        self.gen = Generator(cfg, GenerateConfig(max_new_tokens=max_new_tokens,
                                                 eos_token_id=cfg.eos_token_id))

    def answer(self, image: np.ndarray, question: str) -> str:
        from ..utils.numwords import digits_to_words
        from .decode import eval_batch

        image = np.asarray(image)
        # the collator's sample: (question, answer, rgb, depth3, idx)
        batch = self.collator([(question, "", image, image, 0)])
        batch = eval_batch(batch, self.device)
        out = self.gen.generate(self.model, batch)
        plen = int(out["prompt_lengths"][0])
        seq, valid = out["sequences"][0, plen:].cpu().tolist(), out["valid"][0, plen:].cpu().tolist()
        ids = [t for t, v in zip(seq, valid) if v]
        if ids and ids[-1] == self.cfg.eos_token_id:
            ids = ids[:-1]
        return digits_to_words(self.tok.decode(ids).strip()).lower().strip()


def load_student_for_eval(
    checkpoint_dir: Optional[str],
    processor_path: Optional[str] = None,
    *,
    tiny: bool = False,
    cpu: bool = False,
    max_new_tokens: int = 10,
):
    """Build ``answer(image, question)`` from a checkpoint directory: the
    0.5B student (``tiny``: the tiny config, tests) from seed 0, its weights
    replaced by the best checkpoint of ``checkpoint_dir`` (the lowest
    val_loss of the port's ``*.ckpt`` files, ``cli/convert_weights.py``'s
    output among them) when a directory is named.  Flash attention and bf16
    on ``cuda:0``; the plain attention and float32 when ``cpu`` or ``tiny``
    (as the JAX function picks "pallas" or "xla")."""
    from ..cli import common
    from ..configs import llava_onevision_0_5b, llava_onevision_tiny
    from ..train.checkpoint import CheckpointManager, find_best_checkpoint

    device = common.setup_device(argparse.Namespace(cpu=cpu))
    cfg = llava_onevision_tiny() if tiny else llava_onevision_0_5b()
    plain = cpu or tiny
    model = common.init_or_load_params(cfg, None, 0, attn_impl="xla" if plain else "flash", device=device,
                                       dtype=torch.float32 if plain else torch.bfloat16)
    if checkpoint_dir:
        best = find_best_checkpoint(checkpoint_dir)
        if best is None:
            raise SystemExit(f"{checkpoint_dir}: no checkpoint (*.ckpt) in this directory")
        CheckpointManager(checkpoint_dir).restore_model(best, model, map_location=device)
        print(f"loaded student params from {best}", flush=True)
    tok = common.make_tokenizer(argparse.Namespace(tokenizer_path=processor_path), cfg)
    ans = StudentAnswerer(model, cfg, tok, max_new_tokens=max_new_tokens,
                          buckets=(256,) if tiny else None, device=device)
    return ans.answer
