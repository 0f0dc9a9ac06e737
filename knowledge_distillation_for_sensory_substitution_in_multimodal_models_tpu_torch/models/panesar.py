"""Panesar-style non-LLM VQA baseline (port of the JAX package's
``models/panesar.py``; the reference's
`further_scripts/Panesar_Recreation/models/vqa_sunrgbd_model.py:5-160`):
VGG16 image encoders, a 2-layer LSTM question encoder, one of five RGB-D
fusion modes (hadamard, addition, maxpool, conv1d, fusion_at_start) and a
linear classifier head.

No kernel is involved: the JAX package leaves all of it to XLA, and here it
is ``nn.Conv2d``, ``nn.LSTM`` and ``nn.Linear`` in float32, NCHW.  Module
and parameter names follow the Flax modules (``img_enc_rgb.fc1``,
``q_enc_depth.lstm_0``, ``conv1d``, ``mlp``), and ``features`` keeps
torchvision's ``vgg16.features`` positions, so that a local torchvision
state dict overlays by name (:func:`convert_vgg16_state_dict`).
``models/convert.py::panesar_params_from_flax`` carries a Flax tree across.

Differences from the Flax modules, by design of torch:

* fc1's in-features are fixed at build time, ``512 * (img_size // 32) ** 2``
  (25088 at the reference's 224), where Flax infers them at init;
* dropout takes an explicit ``torch.Generator`` (fresh masks each call); the
  JAX CLI's step draws every step's masks from ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
FUSIONS = ("hadamard", "addition", "maxpool", "conv1d", "fusion_at_start")
DROPOUT = 0.5


def vgg16_conv_positions():
    """torchvision's ``features`` index of each of the 13 convs (conv, ReLU
    and pools each take a position)."""
    out, pos = [], 0
    for v in VGG16_CFG:
        if v == "M":
            pos += 1
        else:
            out.append(pos)
            pos += 2
    return out


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``generator`` (Flax's
    ``Dropout``: keep with 1 - p, scale by 1 / (1 - p))."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class VGG16Features(nn.Sequential):
    """torchvision ``vgg16.features`` (NCHW): [B, 3, H, W] -> [B, 512, H/32, W/32]."""

    def __init__(self):
        layers, in_ch = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(inplace=True)]
                in_ch = v
        super().__init__(*layers)


class ImageEncoder(nn.Module):
    """VGG16 trunk and the first two classifier FCs -> [B, 4096]
    (`vqa_sunrgbd_model.py:5-42`; no avgpool, as the Flax module has none;
    the 1000-way layer dropped)."""

    def __init__(self, img_size: int = 224):
        super().__init__()
        self.features = VGG16Features()
        self.fc1 = nn.Linear(512 * (img_size // 32) ** 2, 4096)
        self.fc2 = nn.Linear(4096, 4096)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        x = self.features(x).flatten(1)  # CHW order, as the Flax module flattens
        x = F.relu(self.fc1(x))
        if not deterministic:
            x = dropout(x, DROPOUT, generator)
        x = F.relu(self.fc2(x))
        if not deterministic:
            x = dropout(x, DROPOUT, generator)
        return x


class QuestionEncoder(nn.Module):
    """Embedding and a 2-layer LSTM; the two layers' final hidden states
    concatenated -> FC -> tanh (`vqa_sunrgbd_model.py:44-80`).  Two 1-layer
    LSTMs, run over every position (no packing), as Flax's ``nn.RNN`` over
    ``OptimizedLSTMCell`` with zero initial carries.  That cell has one bias
    a gate (on its hidden-state kernels), so each LSTM's ``bias_ih_l0`` is
    held at zero and takes no gradient; ``bias_hh_l0`` is the cell's bias."""

    def __init__(self, vocab_size: int, embed_size: int = 300, hidden_size: int = 512, out_size: int = 4096):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_size)
        self.lstm_0 = nn.LSTM(embed_size, hidden_size, batch_first=True)
        self.lstm_1 = nn.LSTM(hidden_size, hidden_size, batch_first=True)
        for lstm in (self.lstm_0, self.lstm_1):
            nn.init.zeros_(lstm.bias_ih_l0)
            lstm.bias_ih_l0.requires_grad_(False)
        self.fc = nn.Linear(2 * hidden_size, out_size)

    def forward(self, question):  # [B, S] int
        x, (h0, _) = self.lstm_0(self.embedding(question))
        _, (h1, _) = self.lstm_1(x)
        return torch.tanh(self.fc(torch.cat([h0[0], h1[0]], dim=-1)))


class PanesarVQAModel(nn.Module):
    """``VQASUNRGBDModel`` (`vqa_sunrgbd_model.py:82-160`): images NCHW
    float32 [B, 3, img_size, img_size], questions [B, S] int -> logits
    [B, num_classes]."""

    def __init__(self, vocab_size: int, num_classes: int = 818, embed_size: int = 300, hidden_size: int = 512,
                 fusion_method: str = "conv1d", img_size: int = 224):
        super().__init__()
        fm = fusion_method.lower()
        if fm not in FUSIONS:
            raise ValueError(f"Unknown fusion method {fm}")
        self.fusion_method = fm
        if fm == "fusion_at_start":
            self.img_enc = ImageEncoder(img_size)
            self.q_enc = QuestionEncoder(vocab_size, embed_size, hidden_size)
        else:
            self.img_enc_rgb = ImageEncoder(img_size)
            self.img_enc_depth = ImageEncoder(img_size)
            self.q_enc_rgb = QuestionEncoder(vocab_size, embed_size, hidden_size)
            self.q_enc_depth = QuestionEncoder(vocab_size, embed_size, hidden_size)
            if fm == "conv1d":
                self.conv1d = nn.Conv1d(2, 1, 1)
        self.mlp = nn.Linear(4096, num_classes)

    def forward(self, img_rgb, img_depth, question, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        fm = self.fusion_method
        if fm == "fusion_at_start":
            img = self.img_enc(torch.maximum(img_rgb, img_depth), deterministic, generator)
            h = self.q_enc(question) * img
        else:
            f_rgb = self.img_enc_rgb(img_rgb, deterministic, generator)
            f_depth = self.img_enc_depth(img_depth, deterministic, generator)
            h_rgb = self.q_enc_rgb(question) * f_rgb
            h_depth = self.q_enc_depth(question) * f_depth
            if fm == "hadamard":
                h = h_rgb * h_depth
            elif fm == "addition":
                h = h_rgb + h_depth
            elif fm == "maxpool":
                h = torch.maximum(h_rgb, h_depth)
            else:  # conv1d: Flax Conv(1, (1,)) over [B, 4096, 2] is Conv1d(2, 1, 1) over [B, 2, 4096]
                h = self.conv1d(torch.stack([h_rgb, h_depth], dim=1))[:, 0]
        return self.mlp(h)


def convert_vgg16_state_dict(sd: Dict, params: Dict, prefix: str = "") -> Dict:
    """Overlay torchvision vgg16 weights (``features`` and classifier[0, 3])
    onto an :class:`ImageEncoder` state dict ``params`` (the JAX
    ``convert_vgg16_state_dict`` in the port's layout: the convs keep their
    torchvision names, classifier.0 / .3 become fc1 / fc2).  Returns a new
    dict; ``params`` is not changed."""
    out = dict(params)
    for p in vgg16_conv_positions():
        for leaf in ("weight", "bias"):
            out[f"features.{p}.{leaf}"] = torch.as_tensor(sd[f"{prefix}features.{p}.{leaf}"])
    for src, dst in ((0, "fc1"), (3, "fc2")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = torch.as_tensor(sd[f"{prefix}classifier.{src}.{leaf}"])
    return out
