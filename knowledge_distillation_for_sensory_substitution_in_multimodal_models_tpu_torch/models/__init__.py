"""Model definitions: SigLIP tower, Qwen2 LM, LLaVA-OneVision, weight conversion."""

from .llava_onevision import LlavaOnevision, init_weights, set_attn_impl
from .qwen2 import Qwen2LM
from .siglip import SigLIPVisionTower

__all__ = ["LlavaOnevision", "Qwen2LM", "SigLIPVisionTower", "init_weights", "set_attn_impl"]
