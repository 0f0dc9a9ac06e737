"""Seeded weights of a configuration's models, drawn on the device.

``leaves(model)`` lists every parameter of a LLaVA-OneVision model by its
HF name (the port's names too), with its shape and how it is drawn:
linear and conv kernels normal with std fan_in^-0.5, token and position
embeddings std 0.02, the image newline std hidden^-0.5, biases 0 and norm
scales 1; the language model's leaves come from its architecture's module
(``archs/<model_type>.py``), built with ``linear`` and ``norm``.
``generate`` draws the normal leaves from one
``torch.Generator`` in a few large calls (groups of about 2^28 values, in
the served dtype) and hands each leaf to ``sink(name, tensor)``; the
tensor is a temporary that the sink copies or keeps.  The same seed and
model give the same tensors, so the program and the reference are handed
identical weights.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from . import archs

Leaf = Tuple[str, Tuple[int, ...], str, float]  # name, shape, "normal" | "zeros" | "ones", std

GROUP_ELEMENTS = 1 << 28
STREAMS = {"student": 0, "teacher": 1}


def linear(name: str, out: int, inp: int, bias: bool) -> List[Leaf]:
    leaves = [(f"{name}.weight", (out, inp), "normal", inp**-0.5)]
    return leaves + ([(f"{name}.bias", (out,), "zeros", 0.0)] if bias else [])


def norm(name: str, dim: int, bias: bool) -> List[Leaf]:
    leaves = [(f"{name}.weight", (dim,), "ones", 0.0)]
    return leaves + ([(f"{name}.bias", (dim,), "zeros", 0.0)] if bias else [])


def leaves(model: dict) -> List[Leaf]:
    """Every parameter of the model section ``model`` of a configuration."""
    vc, tc = model["vision_config"], model["text_config"]
    dv, dt, p = vc["hidden_size"], tc["hidden_size"], vc["patch_size"]
    tokens = (vc["image_size"] // p) ** 2
    out: List[Leaf] = [
        ("vision_tower.patch_embedding.weight", (dv, 3, p, p), "normal", (3 * p * p) ** -0.5),
        ("vision_tower.patch_embedding.bias", (dv,), "zeros", 0.0),
        ("vision_tower.position_embedding", (tokens, dv), "normal", 0.02),
    ]
    for i in range(vc["num_hidden_layers"]):
        v = f"vision_tower.layers.{i}"
        out += norm(f"{v}.layer_norm1", dv, True)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += linear(f"{v}.self_attn.{proj}", dv, dv, True)
        out += norm(f"{v}.layer_norm2", dv, True)
        out += linear(f"{v}.mlp.fc1", vc["intermediate_size"], dv, True)
        out += linear(f"{v}.mlp.fc2", dv, vc["intermediate_size"], True)
    out += norm("vision_tower.post_layernorm", dv, True)
    bias = model["multimodal_projector_bias"]
    out += linear("multi_modal_projector.linear_1", dt, dv, bias)
    out += linear("multi_modal_projector.linear_2", dt, dt, bias)
    out.append(("image_newline", (dt,), "normal", dt**-0.5))
    out += archs.of(tc).leaves(tc)
    return out


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed (any whole number) and tags."""
    state = np.random.SeedSequence([seed % 2**64, *tags]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generate(model: dict, seed: int, stream: str, device, sink: Callable[[str, torch.Tensor], None],
             dtype: torch.dtype = torch.bfloat16) -> None:
    """Draw ``model``'s weights for ``stream`` ("student" or "teacher") from
    ``seed`` on ``device`` in ``dtype`` and hand each leaf to ``sink``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1, STREAMS[stream]))
    specs = leaves(model)
    group: List[Leaf] = []

    def flush():
        n = sum(int(np.prod(s)) for _, s, _, _ in group)
        buf = torch.randn(n, generator=g, device=device, dtype=dtype)
        off = 0
        for name, shape, _, std in group:
            k = int(np.prod(shape))
            sink(name, buf[off:off + k].view(shape).mul(std))
            off += k
        group.clear()

    for leaf in specs:
        name, shape, kind, _ = leaf
        if kind == "normal":
            group.append(leaf)
            if sum(int(np.prod(s)) for _, s, _, _ in group) >= GROUP_ELEMENTS:
                flush()
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            sink(name, fill(shape, device=device, dtype=dtype))
    if group:
        flush()
